"""The port's command-line entry point: ``python -m sca_ldpc_tpu_torch.cli.main
<command> [flags]`` (the JAX package's ``cli/main.py`` commands and flags, plus
``--device``)."""
