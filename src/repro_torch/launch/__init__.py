"""Deployment helpers of the port: the device mesh of a sharded cache."""
