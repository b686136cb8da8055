"""Several-rank masked multi-circulant decoding of attack instances.

Counterpart of the JAX package's ``parallel/attack.py``.  Independent
key-recovery attack instances are the data-parallel axis of the attack
(the reference's process-level sweep).  Their masked decodes
(``ops/circulant_bp._multi_circulant_bp``) share one shape because the
circulants' shifts are data, so the instance axis splits over the mesh's
ranks: each rank decodes its instances in one launch of the CUDA kernel K8
on per-instance shifts ``[I_local, P, W]`` (each instance keeps its own
early exit, as the JAX package's ``vmap`` of one decode an instance does),
and the decisions are gathered to every rank.
"""

import torch

from ..ops.circulant_bp import _multi_circulant_bp


def decode_rows(prior_c, prior_i, syndrome, shifts, rows, device, max_iter=100, method="product_sum"):
    """The instances ``rows`` of a masked decode, on ``device`` in one
    :func:`_multi_circulant_bp` call (one K8 launch on a CUDA device): a
    rank's part of the sharded decode.  Arguments as the sharded decode's,
    numpy arrays or tensors; returns ``(e_c, e_i, conv)`` of those rows."""
    def take(a, dtype):
        return torch.as_tensor(a[rows], dtype=dtype, device=device).contiguous()

    e_c, e_i, conv, _it = _multi_circulant_bp(take(prior_c, torch.float32), take(prior_i, torch.float32),
                                              take(syndrome, torch.int32), take(shifts, torch.int32),
                                              max_iter, method)
    return e_c, e_i, conv


def make_sharded_masked_decode(mesh, max_iter=100, method="product_sum"):
    """Build the sharded masked-circulant decode over the instance axis.

    Returns ``decode(prior_c [I, N], prior_i [I, P, N], syn [I, P, N],
    shifts [I, P, W]) -> (e_c [I, N], e_i [I, P, N], conv [I])`` on the
    mesh's device, every rank passing the same inputs (SPMD) and getting
    every instance's decisions; rank ``r`` decodes its block of
    ``I / ranks`` instances.  I must be a multiple of the mesh's size.  The
    ranks first compare the inputs' shape and a checksum of the syndromes
    and shifts, and raise together when they differ.
    """
    def decode(prior_c, prior_i, syn, shifts):
        i_n = len(prior_c)
        if i_n % mesh.size:
            raise ValueError(f"instance count {i_n} not a multiple of {mesh.size} ranks")
        checksums = [int(torch.as_tensor(a).to(torch.int64).sum()) for a in (syn, shifts)]
        mesh.check_same([*syn.shape, shifts.shape[-1], *checksums], "the masked decode's inputs")
        e_c, e_i, conv = decode_rows(prior_c, prior_i, syn, shifts, mesh.rows(i_n), mesh.device, max_iter, method)
        return mesh.all_gather(e_c), mesh.all_gather(e_i), mesh.all_gather(conv)

    return decode
