"""Generator, discriminator and feature-extractor modules."""
