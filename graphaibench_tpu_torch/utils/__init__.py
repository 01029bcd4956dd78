"""Timers, profiler capture and checkpoints of the training loop."""
