"""Fault injection and the fault-tolerance runtime of one host."""
