"""Meters, expert-usage telemetry and metric writers."""
