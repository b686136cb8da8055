"""sca-ldpc-tpu, PyTorch/CUDA port: batched LDPC belief-propagation decoding
for code-based key-recovery side-channel attack simulation, on NVIDIA GPUs.

A second package beside the JAX package ``sca_ldpc_tpu``, which stays the
reference; module paths mirror it.  Ported:

- ``codes``:    the regular, quasi-cyclic, random and q-ary QC constructors,
                the distance-spectrum-constrained random circulant, the
                layouts :class:`~sca_ldpc_tpu_torch.codes.layout.CodeLayout`
                and :class:`~sca_ldpc_tpu_torch.codes.layout.CirculantLayout`,
                and ``codes.util`` (``rep_code``, GF(2) rank, code parameters)
- ``channels``: probability -> LLR conversions and
                :class:`~sca_ldpc_tpu_torch.channels.errors.ErrorsProvider`
                (per-position error distributions, sampled on the device)
- ``utils``:    seeding (``numpy.random.RandomState``, ``torch.Generator``),
                the device rule (``utils.device``), the CLI's
                ``CommandsBase`` and pandas-free CSV tables (``utils.table``)
- ``ops``:      :class:`~sca_ldpc_tpu_torch.ops.circulant_bp.CirculantBPDecoder`,
                syndrome BP on ``[circulant | I]`` codes, and the masked
                multi-circulant decode of the HQC attack, with hand-written
                CUDA kernels (``csrc/circulant_bp.cu``, ``circulant_lean.cu``,
                ``circulant_multi.cu``) on the GPU;
                :class:`~sca_ldpc_tpu_torch.ops.binary_bp.BinaryBPDecoder`,
                BP on general binary codes;
                :class:`~sca_ldpc_tpu_torch.ops.qary.QaryDecoder`, q-ary
                min-sum with the min-plus chain (``ops/minplus.py``), and
                :class:`~sca_ldpc_tpu_torch.ops.qary_special.QarySpecialDecoder`,
                the two-alphabet decoder of ``[H'|I]`` codes, with three
                hand-written CUDA kernels (``csrc/qary_min_sum.cu``); the
                decoder-name registry
- ``models``:   ``models.hqc``, the HQC key-recovery attack (the native HQC
                binding, the fast, native and measured-timing oracles, three
                decode backends, batched multi-instance attacks (their rounds
                also split over ranks), checkpoints,
                ``hqc_eval_oracle``), and ``models.kyber``, the Kyber-768
                key-recovery pipeline (fixed-pattern and adaptive)
- ``parallel``: the binary frame-error-rate step and loop on one device,
                and several ranks on ``torch.distributed`` (NCCL on cards,
                gloo on the CPU): ``init_distributed``, the ``(data, model)``
                mesh, the sharded FER step, masked decode, q-ary FER step
                and special decode
- ``sim``:      binary and q-ary frame-error-rate simulation
- ``cli``:      ``python -m sca_ldpc_tpu_torch.cli.main <command>``, the JAX
                CLI's 13 commands and flags plus ``--device``
- ``viz``:      the attack statistics' plots (pandas, matplotlib, seaborn)
- ``scripts``:  ``attack_phase_profile``, ``sweep_hqc``, ``profile_trace``,
                the timing-attack scripts, ``fer_curve``, ``multihost_fer``,
                the Kyber curves and cross-validation and
                ``hqc192_diagnostics``, each run as
                ``python -m sca_ldpc_tpu_torch.scripts.<name>``
- ``tools``:    the card's measurement harnesses (kernel forms, attack cells)

Not ported, by design: TPU and XLA compile options (the Pallas kernels'
tiling switches, ``utils/compilation_cache.py``, ``scripts/lean_sweep.py``),
the JAX package's entry module ``__graft_entry__.py`` and its benchmark
``bench.py``.
"""

__version__ = "0.1.0"
