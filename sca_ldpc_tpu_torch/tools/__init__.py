"""Measurement tools for the port's kernels; each runs on an NVIDIA GPU as
``python3 -m sca_ldpc_tpu_torch.tools.<name>`` from the repository root."""
