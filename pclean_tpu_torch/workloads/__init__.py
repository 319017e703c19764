"""Workloads the port runs end to end."""
