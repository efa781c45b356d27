"""T-axis-sharded SSNT lattice loss: a ring over the mesh's model axis.

Mirrors ssnt_tts_tpu/ops/lattice_sharded.py, which is XLA scan code with
`ppermute` (no Pallas kernel), in plain PyTorch with torch.distributed
send / recv. The column recursion

    alpha_u[t] = lf[t,u] + lse(alpha_{u-1}[t] + le[t,u-1],
                               alpha_{u-1}[t-1] + ls[t-1,u-1])

couples two shards of T only through the element t-1 at a shard's left
edge, so each shard walks its own (U, B, T/n) slice and takes ONE (B,)
boundary value per column from its left neighbor: a ring hop, never an
all-to-all. The beta recursion mirrors it (element t+1, from the right
neighbor). The walk starts from JAX's virtual column alpha_{-1} =
onehot(t == 0) with le_prev = 0, ls_prev = NEG, so alpha_0 comes out of
the uniform recursion.

Two arms, as in JAX (`block`):
  - block=1: per-column exchange, U hops a walk;
  - block=K > 1: the staggered blocked wavefront. At outer step s shard i
    walks block s - i (idle outside [0, U/K)) and then hands that block's K
    edge values to its neighbor in one hop: U/K + n - 1 hops a walk, at
    the cost of a bubble of (n - 1) K idle columns.
A walk ends with one sum over the group: logZ is held by the shard that
owns t = input_length - 1 (0 on the others).

Gradients: `_RingLoss` is one torch.autograd.Function over the rank's
slice. Its forward runs the alpha ring (hop right) and keeps the alphas;
its backward runs the beta ring (hop left), forms the posteriors of the
slice (ops/lattice.posterior_grads with the slice's first position and
the right neighbor's column in place of the shift's fill) and all-gathers the slices, so every rank of
the model group returns the whole-T gradient of its whole-T inputs (what
JAX's transpose of the slice does), and the group's parameter gradients
stay equal. The order of the hops is fixed: the loss graph holds one node
that communicates, autograd reaches its backward once, and every rank of
the group runs the same sequence of hops in it.

Training configs reach this path through `tshard_lattice` (entered by
parallel/train.make_sharded_train_step when
ModelConfig.lattice_tshard_min_cells is set): models/ssnt.lattice_loss
sends a lattice here when `active_tshard` says so.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from ssnt_tts_tpu_torch.ops import lattice
from ssnt_tts_tpu_torch.ops.lattice import NEG, beta_column, logaddexp

# Communication counts since the last reset: ring hops of the forward and
# the backward walks, group sums (one a forward) and all_gathers (one a
# backward).
COUNTS = {"hops_forward": 0, "hops_backward": 0, "all_reduce": 0,
          "all_gather": 0}

# ---------------------------------------------------------- dispatch hook

_ACTIVE: list = []  # stack of (mesh, axis, min_cells)


@contextlib.contextmanager
def tshard_lattice(mesh, axis: str = "model", min_cells: int = 0):
    """Context under which models/ssnt.lattice_loss routes lattices of at
    least min_cells cells to ssnt_loss_tsharded over `mesh`'s `axis`."""
    _ACTIVE.append((mesh, axis, int(min_cells)))
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_tshard(U: int, B: int, T: int):
    """The (mesh, axis) to T-shard over, or None. Requires an enclosing
    tshard_lattice context, the cell count met and T divisible by the axis
    size. B is this rank's batch; the count is of the global lattice, B
    times the data axis, the shape JAX's trace sees."""
    if not _ACTIVE:
        return None
    mesh, axis, min_cells = _ACTIVE[-1]
    if U * B * mesh.shape["data"] * T < min_cells or T % mesh.shape[axis]:
        return None
    return mesh, axis


def _pick_block(U: int) -> int:
    """Largest block K <= 32 dividing U (K columns a hop; U/K + n - 1
    hops a walk), else 1."""
    for k in (32, 16, 8, 4, 2):
        if U % k == 0:
            return k
    return 1


# --------------------------------------------------------------- the ring


class _Ring:
    """This rank's place on a mesh axis and its hops."""

    def __init__(self, mesh, axis: str, block: int):
        self.mesh, self.block = mesh, block
        self.group = mesh.groups[axis]
        self.n, self.idx = mesh.shape[axis], mesh.index(axis)
        ranks = mesh.ranks[axis]
        self.left = ranks[self.idx - 1] if self.idx > 0 else None
        self.right = ranks[self.idx + 1] if self.idx < self.n - 1 else None

    def hop(self, x: torch.Tensor, to, frm, count: str):
        """Send x to global rank `to`, receive a tensor like x from `frm`
        (either may be None); returns what was received, or None. Every
        rank of the axis hops together. gloo with CUDA tensors: through
        host memory (mesh.stage_p2p)."""
        if self.n == 1:
            return None
        COUNTS[count] += 1
        stage = self.mesh.stage_p2p
        send = x.cpu() if stage else x.contiguous()
        recv = torch.empty_like(send) if frm is not None else None
        ops = []
        if to is not None:
            ops.append(dist.P2POp(dist.isend, send, to, self.group))
        if frm is not None:
            ops.append(dist.P2POp(dist.irecv, recv, frm, self.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if recv is None:
            return None
        return recv.to(x.device) if stage else recv

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        if self.n > 1:
            COUNTS["all_reduce"] += 1
            dist.all_reduce(x, group=self.group)
        return x

    def gather_t(self, x: torch.Tensor) -> torch.Tensor:
        """(..., Tl) slices of every rank, in axis order -> (..., T)."""
        if self.n == 1:
            return x
        COUNTS["all_gather"] += 1
        parts = [torch.empty_like(x) for _ in range(self.n)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=-1)

    def schedule(self, U: int, up: bool):
        """[(columns of the outer step or None when idle)] for the walk:
        per column (block 1) or the staggered wavefront. up: u ascending
        (the alpha walk, which starts at shard 0), else descending from
        shard n-1."""
        K = self.block
        if K == 1:
            cols = range(U) if up else range(U - 1, -1, -1)
            return [[u] for u in cols]
        nblk = U // K
        lag = self.idx if up else self.n - 1 - self.idx
        steps = []
        for s in range(nblk + self.n - 1):
            j = s - lag
            if not 0 <= j < nblk:
                steps.append(None)
                continue
            if not up:
                j = nblk - 1 - j
            cols = range(j * K, (j + 1) * K)
            steps.append(list(cols if up else reversed(cols)))
        return steps


def _alpha_walk(ring: _Ring, le, ls, lf):
    """Local (U, B, Tl) slices -> alphas (U, B, Tl)."""
    U, B, Tl = le.shape
    dev = le.device
    K = ring.block
    t_glob = ring.idx * Tl + torch.arange(Tl, device=dev)
    alpha = torch.where(t_glob == 0, 0.0, NEG).expand(B, Tl)
    neg_col = torch.full((B,), NEG, device=dev)
    alphas = torch.empty(U, B, Tl, device=dev)
    bnd_in = torch.full((K, B), NEG, device=dev)
    edges = bnd_in.clone()
    for cols in ring.schedule(U, up=True):
        for k, u in enumerate(cols or ()):
            le_p, ls_p = (le[u - 1], ls[u - 1]) if u else (0.0, NEG)
            x = alpha + ls_p
            edges[k] = x[:, -1]
            if K == 1:
                # The edge of the carry (alpha_{u-1} + ls_{u-1}) is what
                # the right neighbor needs for this very column.
                got = ring.hop(edges, ring.right, ring.left, "hops_forward")
                bnd_in = got if got is not None else bnd_in
            first = bnd_in[k] if ring.left is not None else neg_col
            moved = torch.cat([first[:, None], x[:, :-1]], dim=1)
            alpha = lf[u] + logaddexp(alpha + le_p, moved)
            alphas[u] = alpha
        if K > 1:
            got = ring.hop(edges, ring.right, ring.left, "hops_forward")
            bnd_in = got if got is not None else bnd_in
    return alphas


def _beta_walk(ring: _Ring, le, ls, lf, input_length, output_length):
    """Local slices -> (betas (U, B, Tl), right (U, B)): the betas of
    ops/lattice._backward_betas on this slice (its beta_column, the right
    neighbor's edge in place of the fill), and right[u] the right
    neighbor's lf[u+1] + beta[u+1] at its first position (NEG at u = U-1
    and on the last shard)."""
    U, B, Tl = le.shape
    dev = le.device
    K = ring.block
    t_glob = ring.idx * Tl + torch.arange(Tl, device=dev)
    is_last_t = t_glob[None, :] == (input_length.long()[:, None] - 1)
    last_u = output_length.long()[:, None] - 1
    neg = torch.full((B, Tl), NEG, device=dev)
    neg_col = neg[:, 0]
    beta, lf_next = neg, neg
    betas = torch.empty(U, B, Tl, device=dev)
    right = torch.full((U, B), NEG, device=dev)
    bnd_in = torch.full((K, B), NEG, device=dev)
    edges = bnd_in.clone()
    for cols in ring.schedule(U, up=False):
        for u in cols or ():
            k = u % K
            edges[k] = (lf_next + beta)[:, 0]
            if K == 1:
                got = ring.hop(edges, ring.left, ring.right, "hops_backward")
                bnd_in = got if got is not None else bnd_in
            last = bnd_in[k] if ring.right is not None else neg_col
            if ring.right is not None and u < U - 1:
                right[u] = last
            beta = beta_column(le[u], ls[u], lf_next, beta,
                               torch.where(is_last_t, le[u], neg),
                               last_u == u, last)
            lf_next = lf[u]
            betas[u] = beta
        if K > 1:
            got = ring.hop(edges, ring.left, ring.right, "hops_backward")
            bnd_in = got if got is not None else bnd_in
    return betas, right


class _RingLoss(torch.autograd.Function):
    """Whole (U, B, T) float32 inputs on every rank of the axis -> (B,)
    loss, the same on each; the backward returns whole-T gradients."""

    @staticmethod
    def forward(ctx, le, ls, lf, input_length, output_length, ring):
        Tl = le.shape[2] // ring.n
        cut = slice(ring.idx * Tl, (ring.idx + 1) * Tl)
        le_l, ls_l, lf_l = (x[..., cut].contiguous() for x in (le, ls, lf))
        alphas = _alpha_walk(ring, le_l, ls_l, lf_l)
        logz = ring.sum(lattice.gather_logz(
            alphas, le_l, input_length, output_length, t0=cut.start,
            t_total=le.shape[2]))
        ctx.save_for_backward(le_l, ls_l, lf_l, alphas, logz, input_length,
                              output_length)
        ctx.ring = ring
        return -logz

    @staticmethod
    def backward(ctx, g):
        le, ls, lf, alphas, logz, il, ol = ctx.saved_tensors
        ring = ctx.ring
        betas, right = _beta_walk(ring, le, ls, lf, il, ol)
        d = torch.stack(lattice.posterior_grads(
            le, ls, lf, alphas, betas, logz, il, ol, g.contiguous(),
            t0=ring.idx * le.shape[2], right=right))
        d = ring.gather_t(d)
        return d[0], d[1], d[2], None, None, None


def ssnt_loss_tsharded(log_emit, log_shift, log_frame, input_length,
                       output_length, mesh, axis: str = "model",
                       block: Optional[int] = None) -> torch.Tensor:
    """SSNT NLL with the T axis sharded over `mesh`'s `axis`.

    Inputs are the whole time-major (U, B, T) lattice on every rank of the
    axis (cast to float32); T must divide by the axis size. Returns the
    per-example (B,) loss, the same on every rank of the axis;
    differentiable in the three lattice inputs, whose gradients are whole-T
    on every rank. block: columns a hop (default _pick_block(U)); 1 selects
    the per-column exchange."""
    U, B, T = log_emit.shape
    n = mesh.shape[axis]
    if T % n:
        raise ValueError(f"T={T} not divisible by mesh axis {axis}={n}")
    if block is None:
        block = _pick_block(U)
    if U % block:
        raise ValueError(f"U={U} not divisible by block={block}")
    le, ls, lf, il, ol = lattice.canonicalize(
        log_emit, log_shift, log_frame, input_length, output_length,
        layout="ubt")
    return _RingLoss.apply(le, ls, lf, il, ol, _Ring(mesh, axis, block))


def ring_hop(x: torch.Tensor, mesh, axis: str = "model"):
    """One hop of the alpha walk alone: x to the right neighbour on
    `axis`, the left neighbour's tensor like x back (None on the first
    shard), through host memory where mesh.stage_p2p; counted as a forward
    hop. Every rank of the axis calls it together."""
    ring = _Ring(mesh, axis, 1)
    return ring.hop(x, ring.right, ring.left, "hops_forward")


def hops_per_walk(U: int, n: int, block: int) -> int:
    """Ring hops of one walk (forward or backward): U for block 1, else
    U/block + n - 1; none on one shard."""
    if n == 1:
        return 0
    return U if block == 1 else U // block + n - 1


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0
