"""Plain PyTorch reference of the Kyber attack's channel and of its two-alphabet min-sum decode.

The attack code is ``H = [H'|I]``: R checks over N_b secret coefficients in
``[-B, B]`` and R sum variables in ``[-BSUM, BSUM]`` (``BSUM = SW * B``), check
i holding SW coefficients with entries +-1 and sum variable i.  The oracle is
asked, for every coefficient and every check sum, a fixed pattern of binary
questions: the answer to question k is bit k of the symbol's codeword, wrong
with probability ``1 - accuracy``.

- :func:`check_sums`: ``H'·s``, computed here from ``H``.
- :func:`channels`: Bayes' rule over the pattern codewords, frame by frame:
  a symbol's posterior is its prior (the centered binomial, :func:`cbd_prior`)
  times ``accuracy`` for each answer that agrees with its codeword and
  ``1 - accuracy`` for each that does not, normalised, in float64; then
  float32 probabilities and min-sum LLRs ``ln(max / p)`` in float32.  A check
  sum's channel is reversed (its symbol x at ``-x``): the identity column
  carries ``-H'·s``, so that every check sums to zero.
- :func:`min_sum`: two-alphabet min-sum, float32 messages, a fixed number of
  iterations, flooding, as ``sca_ldpc_tpu_torch/ops/qary_special.py``
  documents it.  A check's message to coefficient j is the min-plus
  convolution of its other coefficients' messages and its sum variable's
  signed channel, evaluated at the symbol that makes the check sum to zero;
  its message to the sum variable is the min-plus convolution of all SW
  coefficient messages.  The rounding order is the documented one: the
  others' messages folded from the left for those before j and from the
  right for those after it, the two folds added, then the sum variable's
  channel; the full convolution folded from the left; a coefficient's total
  ``channel + ((u_0 + u_1) + ...)`` over its checks in row order.  Each term
  of a min-plus convolution is one float32 add, and rounding is monotone, so
  the mins taken stage by stage give what the minimum over every
  configuration of that sum gives.  A message to a check is the
  coefficient's total less the check's message, shifted to a minimum of 0.

Departures from the program, none of which changes a result on the attack's
channels: every convolution is taken over its whole support (the program
stores each partial at the symbols that can still reach the output; the
symbols it leaves out reach no output); there is no large finite stand-in
for an infinite LLR, so channels must be finite (every posterior of the
attack is above 0); each row of ``H'`` holds the same number of coefficients
(the program pads shorter rows); the sum variable's message to its check is
its channel in every iteration (it has one check, so its total less the
check's message is its channel, as in the program).

``store`` (optional) rounds the messages where they are stored: the
lower-precision control passes ``reference.bp.round_bf16``.  Runs on any
device; it imports nothing of the program under test.
"""

import math

import numpy as np
import torch


def check_sums(H, s):
    """``H'·s`` [F, R] int64 of the secrets ``s`` [F, N_b] under ``H`` = [H'|I]
    ([R, N_b + R]), exact in float64."""
    H = np.asarray(H)
    n_b = H.shape[1] - H.shape[0]
    hp = torch.as_tensor(H[:, :n_b], dtype=torch.float64, device=s.device)
    return torch.round(s.to(torch.float64) @ hp.T).to(torch.int64)


def cbd_prior(count, eta):
    """The prior of a sum of ``count`` centered-binomial(eta) coefficients
    over its symbols ``-count*eta .. count*eta``, float64."""
    n = 2 * count * eta
    return torch.tensor([math.comb(n, k) / 2**n for k in range(n + 1)], dtype=torch.float64)


def channels(answers, codewords, prior, accuracy, reverse=False):
    """Min-sum LLRs [F, V, S] float32 of each variable's answers [F, V, m]
    under ``codewords`` [S, m] (symbol order) and ``prior`` [S]; ``reverse``
    for a check sum's channel."""
    dev = answers.device
    cw = torch.as_tensor(np.asarray(codewords), device=dev)
    agree = answers[:, :, None, :].to(torch.int64) == cw[None, None].to(torch.int64)  # [F, V, S, m]
    acc = torch.tensor(float(accuracy), dtype=torch.float64, device=dev)
    likelihood = torch.where(agree, acc, 1.0 - acc).prod(dim=-1)
    post = likelihood * prior.to(dev)
    p = (post / post.sum(dim=-1, keepdim=True)).to(torch.float32)
    if reverse:
        p = p.flip(-1)
    return torch.log(p.amax(dim=-1, keepdim=True) / p)


def _conv(a, c):
    """Full min-plus convolution: ``a`` [..., 2Sa+1] and ``c`` [..., 2Sc+1]
    (index i is symbol i - S) -> [..., 2(Sa+Sc)+1], ``out[k] = min_i a[i] +
    c[k - i]``."""
    if a.shape[-1] > c.shape[-1]:
        a, c = c, a
    wa, wc = a.shape[-1], c.shape[-1]
    shape = torch.broadcast_shapes(a.shape[:-1], c.shape[:-1]) + (wa + wc - 1,)
    out = torch.full(shape, math.inf, dtype=c.dtype, device=c.device)
    for i in range(wa):
        out[..., i : i + wc] = torch.minimum(out[..., i : i + wc], a[..., i : i + 1] + c)
    return out


def _signed(x, sign):
    """A message under an entry ``sign`` of +-1: the symbol axis reversed where -1."""
    return torch.where(sign[..., None] < 0, x.flip(-1), x)


def _adjacency(H):
    """The code's lists: each check's coefficients and entries (columns in
    ascending order), its sum variable and entry, and each coefficient's
    edges in row order (padded with the edge index E, whose message is 0)."""
    H = np.asarray(H).astype(np.int64)
    r, n = H.shape
    n_b = n - r
    rows, cols = np.nonzero(H[:, :n_b])
    deg = np.bincount(rows, minlength=r)
    if deg.min() != deg.max():
        raise ValueError("the reference takes rows of H' of one weight")
    sw = int(deg[0])
    idx = cols.reshape(r, sw)
    sign = H[rows, cols].reshape(r, sw)
    sum_cols = [np.flatnonzero(H[i, n_b:]) for i in range(r)]
    if any(len(c) != 1 for c in sum_cols) or sorted(int(c[0]) for c in sum_cols) != list(range(r)):
        raise ValueError("H must be [H'|I] up to the order and signs of its last R columns")
    sum_col = np.array([int(c[0]) for c in sum_cols])
    sum_sign = H[np.arange(r), n_b + sum_col]
    edges = [[] for _ in range(n_b)]
    for e, j in enumerate(idx.reshape(-1)):  # edge e = i * SW + slot: row order within each coefficient
        edges[j].append(e)
    dv = max(len(x) for x in edges)
    var_edges = np.array([x + [r * sw] * (dv - len(x)) for x in edges])
    return idx, sign, sum_col, sum_sign, var_edges


def _decode_block(adj, llr, llr_sum, iterations, store):
    idx, sign, sum_col, sum_sign, var_edges = adj
    dev = llr.device
    f, n_b, qb = llr.shape
    r, sw = idx.shape
    b, bsum = (qb - 1) // 2, (llr_sum.shape[-1] - 1) // 2
    idx_t = torch.as_tensor(idx, device=dev)
    sign_t = torch.as_tensor(sign, device=dev)
    sum_sign_t = torch.as_tensor(sum_sign, device=dev)
    var_edges_t = torch.as_tensor(var_edges, device=dev)
    chan_sum = llr_sum[:, torch.as_tensor(sum_col, device=dev)]  # [F, R, QS]: each check's sum variable
    extra = _signed(chan_sum, sum_sign_t)  # the sum variable's message, every iteration
    v2c = _signed(llr[:, idx_t], sign_t)  # [F, R, SW, QB]
    centre = (sw - 1) * b + bsum  # the symbol 0 of a check's whole convolution
    for _ in range(iterations):
        nothing = torch.zeros((f, r, 1), device=dev)  # the convolution of no message: 0 at symbol 0
        prefix = [nothing]
        for j in range(sw):
            prefix.append(_conv(v2c[:, :, j], prefix[-1]))
        suffix = [nothing]
        for j in range(sw - 1, 0, -1):
            suffix.append(_conv(v2c[:, :, j], suffix[-1]))
        suffix = suffix[::-1]  # suffix[j]: the messages after j
        others = torch.stack([_conv(prefix[j], suffix[j]) for j in range(sw)], dim=2)  # [F, R, SW, 2(SW-1)B+1]
        whole = _conv(extra[:, :, None], others)  # [F, R, SW, 2*centre+1]
        c2v = whole[..., centre - b : centre + b + 1].flip(-1)  # at -d for symbol d
        c2v_sum = prefix[sw].flip(-1)  # [F, R, QS]
        if store is not None:
            c2v, c2v_sum = store(c2v), store(c2v_sum)

        u = _signed(c2v, sign_t).reshape(f, r * sw, qb)  # in the coefficients' own symbols
        u = torch.cat([u, torch.zeros((f, 1, qb), device=dev)], dim=1)[:, var_edges_t]  # [F, N_b, DV, QB]
        acc = u[:, :, 0]
        for t in range(1, u.shape[2]):
            acc = acc + u[:, :, t]
        total = llr + acc
        total_sum = chan_sum + _signed(c2v_sum, sum_sign_t)

        v2c = _signed(total[:, idx_t], sign_t) - c2v
        v2c = v2c - v2c.amin(dim=-1, keepdim=True)
        if store is not None:
            v2c = store(v2c)
    hard_b = torch.argmin(total, dim=-1) - b
    hard_sum = torch.empty((f, r), dtype=torch.int64, device=dev)
    hard_sum[:, torch.as_tensor(sum_col, device=dev)] = torch.argmin(total_sum, dim=-1) - bsum
    return torch.cat([hard_b, hard_sum], dim=1).to(torch.int32)


def min_sum(H, llr, llr_sum, iterations, store=None, block=None):
    """Decisions [F, N_b + R] int32 (the coefficients, then the sum variables
    in column order) of the float32 min-sum LLRs ``llr`` [F, N_b, 2B+1] and
    ``llr_sum`` [F, R, 2BSUM+1] (sum variables in column order), decoded
    ``block`` frames at a time (all at once by default)."""
    if iterations < 1:
        raise ValueError("the reference decodes at least one iteration")
    adj = _adjacency(H)
    if llr_sum.shape[-1] != adj[0].shape[1] * (llr.shape[-1] - 1) + 1:
        raise ValueError("the sum variables' alphabet must be SW times the coefficients'")
    block = llr.shape[0] if block is None else int(block)
    return torch.cat([_decode_block(adj, llr[i : i + block], llr_sum[i : i + block], iterations, store)
                      for i in range(0, llr.shape[0], block)], dim=0)
