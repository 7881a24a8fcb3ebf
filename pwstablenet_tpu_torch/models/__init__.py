"""Generator modules."""
