"""Shared pieces of the harness."""
