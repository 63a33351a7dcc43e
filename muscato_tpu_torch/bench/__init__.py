"""Synthetic workload generation for the port's tests and chip smoke run."""
