"""Attack models built on the decoders: ``kyber`` (the Kyber-768 pipeline)."""
