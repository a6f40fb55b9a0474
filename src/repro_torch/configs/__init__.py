"""Configurations of the engine (the paper baseline)."""
