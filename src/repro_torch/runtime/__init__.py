"""runtime"""
