"""Attack models built on the decoders: ``kyber`` (the Kyber-768 pipeline)
and ``hqc`` (the HQC key-recovery attack with an idealized oracle)."""
