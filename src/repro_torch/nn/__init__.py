"""Functional neural-network building blocks (the MLP subset of
``repro.nn``)."""
