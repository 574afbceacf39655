"""launch"""
