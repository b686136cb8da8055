"""The port's scripts, each run as ``python -m sca_ldpc_tpu_torch.scripts.<name>``
(the JAX package's ``scripts/`` of the same names): ``attack_phase_profile``,
``sweep_hqc``, ``profile_trace``, ``timing_attack``, ``timing_attack_batched``
and ``timing_attack_stats``."""
