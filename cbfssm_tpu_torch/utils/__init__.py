"""Utilities of the port: JSONL metrics and step timing."""
