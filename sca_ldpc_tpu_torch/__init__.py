"""sca-ldpc-tpu, PyTorch/CUDA port: batched LDPC belief-propagation decoding
for code-based key-recovery side-channel attack simulation, on NVIDIA GPUs.

A second package beside the JAX package ``sca_ldpc_tpu``, which stays the
reference; module paths mirror it.  Ported so far:

- ``codes``:    the distance-spectrum-constrained random circulant and its
                :class:`~sca_ldpc_tpu_torch.codes.layout.CirculantLayout`
- ``utils``:    seeding (``numpy.random.RandomState``, ``torch.Generator``)
- ``ops``:      :class:`~sca_ldpc_tpu_torch.ops.circulant_bp.CirculantBPDecoder`,
                syndrome BP on ``[circulant | I]`` codes, with a hand-written
                CUDA kernel (``csrc/circulant_bp.cu``) on the GPU
- ``parallel``: the single-device frame-error-rate step and loop
"""

__version__ = "0.1.0"
