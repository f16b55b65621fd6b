"""Greedy generation and the captioning entry point."""
