"""Solvers that keep history beyond the Markovian state: sliding-window bundle
adjustment (``ba``)."""
