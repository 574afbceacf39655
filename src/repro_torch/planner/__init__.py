"""planner"""
