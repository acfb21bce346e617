"""Streaming video predictor."""
