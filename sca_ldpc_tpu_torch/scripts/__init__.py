"""The port's scripts, each run as ``python -m sca_ldpc_tpu_torch.scripts.<name>``
(the JAX package's ``scripts/`` of the same names): ``attack_phase_profile``,
``sweep_hqc``, ``profile_trace``, ``timing_attack``, ``timing_attack_batched``,
``timing_attack_stats``, ``fer_curve``, ``multihost_fer``, ``kyber_curve``,
``kyber_noise_curve``, ``kyber_crossvalidate`` and ``hqc192_diagnostics``.

Not ported, by design: ``lean_sweep.py`` (it sweeps Mosaic compile options of
the TPU kernels), the round-4/5 queue and watcher shell scripts, and
``timing_budget_model.py`` and ``timing_conditions.py`` (they import neither
JAX nor the JAX package, and run as they are)."""
