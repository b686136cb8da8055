"""The benchmark of ``sca_ldpc_tpu_torch``: see ``benchmark/README.md``."""
