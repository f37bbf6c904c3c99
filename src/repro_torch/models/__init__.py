"""The LM zoo: one unified transformer for ten architectures (counterpart
of ``repro/models``)."""
