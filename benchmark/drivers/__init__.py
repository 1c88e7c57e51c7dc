"""Drivers: one module a way of driving the program, each with
``run(cell) -> harness.Outcome``."""
