"""Host-side utilities: the TensorBoard event-file writer."""
