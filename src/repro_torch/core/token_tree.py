"""Token-tree packing for multi-draft verification (SpecInfer-style).

Each device uploads J i.i.d. drafts of length L.  Because the SLM
distribution at a position depends only on the token prefix, drafts that
share a token prefix drew from IDENTICAL distributions there — so the J
sequences pack losslessly into a prefix-deduplicated trie: one node per
distinct (parent, token) edge, each node carrying the draft probability and
the uploaded sparse SLM distribution of its position.  The server then
scores ALL nodes in one target pass: the verification window is

    [pending, node_0, node_1, ... ]        (construction order, W+1 slots)

where node i's rope position is ``pos + depth_i`` and attention is masked
to committed KV plus in-window ANCESTORS (``window_mask``).  The target
logits at a node's window slot therefore condition on exactly the
root-to-node path — the quantity tree verification needs for every node's
accept test (``core.verification.verify_tree``).

Construction is host-side numpy (J and L are round-plan sized); everything
returned is padded to the static width W = J * L so the device-side pass
compiles once per (B, J, L) shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np

DEAD = -2  # parent marker for padding nodes (never valid, never attended)
ROOT = -1  # parent marker for depth-1 nodes (their parent is `pending`)


@dataclasses.dataclass
class TokenTreeBatch:
    """A batch of packed draft trees, padded to W = J * L nodes per row.

    tokens:  (B, W) int32   node tokens (0 on dead padding nodes)
    parents: (B, W) int32   in-tree parent index; ROOT (-1) for depth-1
                            nodes, DEAD (-2) marks padding
    depth:   (B, W) int32   1-based node depth (0 on dead nodes)
    probs:   (B, W) f32     p_S of the node token (1.0 on dead nodes so the
                            accept ratio can never fire there)
    q_idx:   (B, W, Vhat)   the node position's uploaded sparse SLM dist
    q_val:   (B, W, Vhat)
    paths:   (B, J, L) int32  node index of draft j's l-th token (shared
                            prefixes point at the same node); -1 past a
                            row's true draft length
    n_nodes: (B,) int32     live node count per row
    """

    tokens: np.ndarray
    parents: np.ndarray
    depth: np.ndarray
    probs: np.ndarray
    q_idx: np.ndarray
    q_val: np.ndarray
    paths: np.ndarray
    n_nodes: np.ndarray

    @property
    def num_drafts(self) -> int:
        return self.paths.shape[1]

    @property
    def width(self) -> int:
        return self.tokens.shape[1]

    def window_tokens(self, pending: np.ndarray) -> np.ndarray:
        """(B, W+1) verification-window tokens: pending at slot 0, node i at
        slot i + 1 (dead nodes ride as zero pads)."""
        pend = np.asarray(pending).reshape(-1, 1)
        return np.concatenate([pend, self.tokens], axis=1).astype(np.int64)

    def window_depth(self) -> np.ndarray:
        """(B, W+1) position offsets of the window: pending at offset 0,
        node i at its tree depth (dead nodes collapse to 0 — their rope
        position is irrelevant, they are never attended)."""
        zero = np.zeros((self.depth.shape[0], 1), self.depth.dtype)
        return np.concatenate([zero, self.depth], axis=1)

    def window_mask(self) -> np.ndarray:
        """(B, W+1, W+1) bool ancestor-or-self matrix over window slots.

        Row/col 0 is the pending token: ancestor of every node, attending
        only itself.  Node i attends pending, its ancestors, and itself.
        Dead nodes keep {pending, self} so their (discarded) softmax row
        stays well-formed; nothing live ever attends them.  A J=1 chain
        yields exactly the lower-triangular causal window mask.
        """
        B, W = self.parents.shape
        T = W + 1
        mask = np.zeros((B, T, T), dtype=bool)
        mask[:, :, 0] = True  # everyone sees pending
        mask[:, 0, 1:] = False  # pending sees only itself
        for b in range(B):
            for i in range(int(self.n_nodes[b])):
                p = self.parents[b, i]
                if p >= 0:
                    mask[b, i + 1] = mask[b, p + 1]
                mask[b, i + 1, i + 1] = True
            for i in range(int(self.n_nodes[b]), W):
                mask[b, i + 1, i + 1] = True  # dead: {pending, self}
        return mask


class TreeScratch:
    """Reusable host-side trie buffers for ``build_token_tree``.

    Multi-draft rounds call the builder every round at a small set of
    recurring (B, J, L) shapes (draft lengths are round-plan bucketed), so
    instead of allocating 8 fresh arrays per call the engine hands the
    builder one of these pools.  Buffers are keyed by the exact
    (B, J, L, Vhat) shape and reset with a HIGH-WATER wipe: only the node
    prefix actually written last round (and the path prefix up to the last
    true draft length) is restored to the fill values, so sparse trees pay
    proportional reset cost, never a full reallocation.

    The returned ``TokenTreeBatch`` ALIASES the pool: it is valid until the
    next ``build_token_tree`` call with the same scratch and shape.  The
    engine uploads the trie to device within the same round, well before
    the next build, so the aliasing is invisible there.
    """

    def __init__(self):
        self._pool: dict[tuple, TokenTreeBatch] = {}
        self._high_water: dict[tuple, tuple[int, int]] = {}

    def acquire(self, B: int, J: int, L: int, Vhat: int) -> TokenTreeBatch:
        key = (B, J, L, Vhat)
        W = J * L
        out = self._pool.get(key)
        if out is None:
            out = _fresh_tree_buffers(B, J, L, Vhat)
            self._pool[key] = out
            return out
        hw_nodes, hw_len = self._high_water.get(key, (W, L))
        out.tokens[:, :hw_nodes] = 0
        out.parents[:, :hw_nodes] = DEAD
        out.depth[:, :hw_nodes] = 0
        out.probs[:, :hw_nodes] = 1.0
        out.q_idx[:, :hw_nodes] = 0
        out.q_val[:, :hw_nodes] = 0.0
        out.paths[:, :, :hw_len] = -1
        out.n_nodes[:] = 0
        return out

    def note(self, B: int, J: int, L: int, Vhat: int, used_nodes: int, used_len: int) -> None:
        """Record how much of the pool the last build touched."""
        self._high_water[(B, J, L, Vhat)] = (int(used_nodes), int(used_len))


def _fresh_tree_buffers(B: int, J: int, L: int, Vhat: int) -> TokenTreeBatch:
    W = J * L
    return TokenTreeBatch(
        tokens=np.zeros((B, W), np.int32),
        parents=np.full((B, W), DEAD, np.int32),
        depth=np.zeros((B, W), np.int32),
        probs=np.ones((B, W), np.float32),
        q_idx=np.zeros((B, W, Vhat), np.int32),
        q_val=np.zeros((B, W, Vhat), np.float32),
        paths=np.full((B, J, L), -1, np.int32),
        n_nodes=np.zeros(B, np.int32),
    )


def build_token_tree(
    tokens: np.ndarray,
    probs: np.ndarray,
    q_idx: np.ndarray,
    q_val: np.ndarray,
    lengths: np.ndarray,
    scratch: TreeScratch | None = None,
) -> TokenTreeBatch:
    """Pack J drafts per row into prefix-deduplicated trees.

    tokens / probs: (B, J, L); q_idx / q_val: (B, J, L, Vhat);
    lengths: (B,) true draft lengths (positions >= lengths_b are padding
    and never become nodes).  ``scratch`` reuses pooled buffers instead of
    allocating — the result then aliases the pool (see ``TreeScratch``).
    """
    tokens = np.asarray(tokens)
    probs = np.asarray(probs)
    q_idx = np.asarray(q_idx)
    q_val = np.asarray(q_val)
    lengths = np.asarray(lengths, dtype=np.int64)
    B, J, L = tokens.shape
    Vhat = q_idx.shape[-1]

    if scratch is not None:
        out = scratch.acquire(B, J, L, Vhat)
    else:
        out = _fresh_tree_buffers(B, J, L, Vhat)
    for b in range(B):
        children: dict[tuple[int, int], int] = {}
        n = 0
        for j in range(J):
            parent = ROOT
            for pos in range(int(lengths[b])):
                tok = int(tokens[b, j, pos])
                key = (parent, tok)
                node = children.get(key)
                if node is None:
                    node = n
                    children[key] = node
                    out.tokens[b, node] = tok
                    out.parents[b, node] = parent
                    out.depth[b, node] = pos + 1
                    out.probs[b, node] = probs[b, j, pos]
                    out.q_idx[b, node] = q_idx[b, j, pos]
                    out.q_val[b, node] = q_val[b, j, pos]
                    n += 1
                out.paths[b, j, pos] = node
                parent = node
        out.n_nodes[b] = n
    if scratch is not None:
        scratch.note(B, J, L, Vhat, int(out.n_nodes.max(initial=0)), int(lengths.max(initial=0)))
    return out
