"""Adaptive (tree-coded) measurement support for eta=3 parameter sets.

The reference's adaptive posterior functions take a ``coding_tree`` with
``value``/``left``/``right`` attributes (max_likelihood.py:109-175) but never
construct one in-repo; the adaptive pattern database
(kyber.py:268-283) encodes per-symbol variable-length codewords.  This module
supplies the missing piece: build the decision tree implied by an adaptive
pattern set, so the adaptive posteriors are actually usable.  A copy of the
JAX package's ``models/kyber/adaptive.py``.
"""

from dataclasses import dataclass


@dataclass
class CodingNode:
    value: float  # decision threshold: measure "s < value"
    left: "CodingNode | None" = None  # taken on answer 1
    right: "CodingNode | None" = None  # taken on answer 0


def tree_from_adaptive_pattern(pattern, eta=3):
    """Build the decision tree for an adaptive per-symbol codeword table.

    ``pattern[i]`` is the measurement-answer sequence produced for symbol
    ``s = i - B`` (B = eta): a prefix-free code over {0,1}.  The implied
    tree asks threshold questions; answer 1 descends left (s below the
    node's threshold), 0 right, matching pr_cond_yx_adaptive's convention
    (max_likelihood.py:109-130).
    """
    b = eta
    symbols = list(range(-b, b + 1))
    if len(pattern) != len(symbols):
        raise ValueError("pattern length must be 2*eta + 1")
    codes = {s: tuple(p) for s, p in zip(symbols, pattern)}

    def build(cands, prefix):
        if len(cands) == 1:
            s = cands[0]
            if codes[s][len(prefix):]:
                # degenerate chain: keep splitting until the code is consumed
                pass
            else:
                return None
        lefts = [s for s in cands if codes[s][len(prefix)] == 1]
        rights = [s for s in cands if codes[s][len(prefix)] == 0]
        if not lefts or not rights:
            # all candidates agree on this answer: pass-through node
            nxt = lefts or rights
            child = build(nxt, prefix + (codes[nxt[0]][len(prefix)],))
            return child
        # answer 1 means "s < threshold": lefts must all be below rights
        if max(lefts) >= min(rights):
            raise ValueError("adaptive pattern is not threshold-consistent")
        thr = (max(lefts) + min(rights) + 1) / 2.0
        node = CodingNode(value=thr)
        if len(lefts) > 1 or codes[lefts[0]][len(prefix) + 1 :]:
            node.left = build(lefts, prefix + (1,))
        if len(rights) > 1 or codes[rights[0]][len(prefix) + 1 :]:
            node.right = build(rights, prefix + (0,))
        return node

    return build(symbols, ())
