"""sca-ldpc-tpu, PyTorch/CUDA port: batched LDPC belief-propagation decoding
for code-based key-recovery side-channel attack simulation, on NVIDIA GPUs.

A second package beside the JAX package ``sca_ldpc_tpu``, which stays the
reference; module paths mirror it.  Ported so far:

- ``codes``:    the regular, quasi-cyclic and q-ary QC constructors, the
                distance-spectrum-constrained random circulant, and the
                layouts :class:`~sca_ldpc_tpu_torch.codes.layout.CodeLayout`
                and :class:`~sca_ldpc_tpu_torch.codes.layout.CirculantLayout`
- ``channels``: probability -> LLR conversions
- ``utils``:    seeding (``numpy.random.RandomState``, ``torch.Generator``)
- ``ops``:      :class:`~sca_ldpc_tpu_torch.ops.circulant_bp.CirculantBPDecoder`,
                syndrome BP on ``[circulant | I]`` codes, with a hand-written
                CUDA kernel (``csrc/circulant_bp.cu``) on the GPU;
                :class:`~sca_ldpc_tpu_torch.ops.qary.QaryDecoder`, q-ary
                min-sum with the min-plus chain (``ops/minplus.py``), and
                :class:`~sca_ldpc_tpu_torch.ops.qary_special.QarySpecialDecoder`,
                the two-alphabet decoder of ``[H'|I]`` codes, with three
                hand-written CUDA kernels (``csrc/qary_min_sum.cu``); the
                decoder-name registry
- ``models``:   ``models.kyber``, the Kyber-768 key-recovery pipeline
                (secrets, pattern databases, posteriors, the fixed-pattern
                and adaptive attack simulations)
- ``parallel``: the single-device binary frame-error-rate step and loop
- ``sim``:      the q-ary frame-error-rate simulation
"""

__version__ = "0.1.0"
