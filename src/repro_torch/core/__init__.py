"""core"""
