"""Analytic roofline cost model per (op, algorithm) — the planner's pricing.

The counterpart of ``repro/core/cost_model.py``: the same per-algorithm
FLOP / traffic / workspace / on-chip-memory rows, the same co-execution,
stacked, grouped and chained makespans, and the same serving bucket
ladder.  Every time it returns is priced against ``PROFILE``, which is
``TPU_PLANNER_PROFILE``: the reference planner's TPU constants, kept so
that this package lowers exactly the plans the reference lowers.  None of
its numbers describes the GPU this package runs on, and nothing here is a
speed or memory claim about it; a profile measured on the H100 is later
work.

What the serving and training lowerings reach is here, the backward
pricing included; the MoE and spatial pricing wait for the slices that
need them.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.graph import Op


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """The constants a plan is priced against."""
    name: str
    peak_flops: float            # FLOP/s per chip
    hbm_bw: float                # device-memory B/s per chip
    ici_bw: float                # B/s per inter-chip link
    vmem_bytes: float            # on-chip scratch budget (C2 static budget)
    hbm_bytes: float             # device memory per chip (C2 workspace budget)
    # a lone kernel's unhidden share of min(compute, memory): max(c, m) +
    # pipeline_loss * min(c, m); a co-execution group amortizes it
    pipeline_loss: float
    # XLA-style interleaving recovers only part of the co-execution
    # overlap: priced this far from perfect overlap towards serial
    xla_interleave_loss: float


#: The JAX planner's TPU profile (v5e-class chip), kept so that plans
#: match the reference's.  Not a description of the H100.
TPU_PLANNER_PROFILE = HardwareProfile(
    name="jax-planner-tpu-v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    vmem_bytes=128 * 1024 * 1024,
    hbm_bytes=16 * 1024**3,
    pipeline_loss=0.2,
    xla_interleave_loss=0.5,
)

PROFILE = TPU_PLANNER_PROFILE

#: The planner's C2 budgets (the reference's defaults): a quarter of the
#: device memory for workspace, the whole on-chip scratch for static claims.
HBM_BUDGET = PROFILE.hbm_bytes * 0.25
VMEM_BUDGET = PROFILE.vmem_bytes


@dataclasses.dataclass(frozen=True)
class OpProfile:
    """The per-(op, algorithm) profile — Table-1/Table-2 analogue row."""
    op: str
    algorithm: str
    flops: float
    hbm_bytes: float          # total HBM traffic
    workspace_bytes: float    # HBM workspace (Table 2)
    vmem_bytes: float         # static VMEM claim (Table 1)

    @property
    def compute_time(self) -> float:
        return self.flops / PROFILE.peak_flops

    @property
    def memory_time(self) -> float:
        return self.hbm_bytes / PROFILE.hbm_bw

    @property
    def time(self) -> float:
        c, m = self.compute_time, self.memory_time
        return max(c, m) + PROFILE.pipeline_loss * min(c, m)

    @property
    def intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)

    @property
    def bound(self) -> str:
        return "compute" if self.compute_time >= self.memory_time else "memory"


def _mxu_efficiency(*dims: int) -> float:
    """Alignment-derate: each matmul dim not a multiple of 128 wastes the
    padded fraction of the systolic array."""
    eff = 1.0
    for d in dims:
        pad = -(-d // 128) * 128
        eff *= d / pad
    return max(eff, 0.05)


ALGORITHMS_BY_KIND = {
    "matmul": ("mxu128", "large_tile", "ksplit"),
    "conv2d": ("im2col_gemm", "direct", "winograd3x3"),
    "pointwise": ("vpu",),
    "maxpool": ("reduce_window",),
}


def profile(op: Op, algorithm: str) -> OpProfile:
    p, eb = op.p, op.dtype_bytes
    if op.kind == "matmul":
        m, k, n = p["m"], p["k"], p["n"]
        flops = 2.0 * m * k * n / _mxu_efficiency(m, k, n)
        io = (m * k + k * n + m * n) * eb
        ws = 0.0
        vmem = 0.0
        if algorithm == "mxu128":
            vmem = (128 * 128 * 2) * eb + 128 * 128 * 4
        elif algorithm == "large_tile":
            flops = 2.0 * m * k * n / _mxu_efficiency(m, n)  # K always aligned
            vmem = (256 * 128 + 128 * 256) * eb + 256 * 256 * 4
            # 256-tiles halve the number of lhs/rhs reloads across the grid:
            io = (m * k + k * n) * eb * 0.75 + m * n * eb
        elif algorithm == "ksplit":
            splits = 4
            ws = splits * m * n * 4
            io = (m * k + k * n + m * n) * eb + 2 * ws  # write + reduce read
            vmem = (128 * 128 * 2) * eb + 128 * 128 * 4
        return OpProfile(op.name, algorithm, flops, io, ws, vmem)

    if op.kind == "conv2d":
        n_, h, w, c = p["n"], p["h"], p["w"], p["c"]
        kh, kw, k, s = p["kh"], p["kw"], p["k"], p.get("stride", 1)
        oh, ow = -(-h // s), -(-w // s)
        mac = n_ * oh * ow * kh * kw * c * k
        xin = n_ * h * w * c * eb
        xout = n_ * oh * ow * k * eb
        wts = kh * kw * c * k * eb
        if algorithm == "im2col_gemm":
            ws = n_ * oh * ow * kh * kw * c * eb
            flops = 2.0 * mac / _mxu_efficiency(n_ * oh * ow, kh * kw * c, k)
            io = xin + xout + wts + 2 * ws
            vmem = (128 * 128 * 2) * eb + 128 * 128 * 4
        elif algorithm == "direct":
            ws = 0.0
            flops = 2.0 * mac / _mxu_efficiency(c, k)
            # overlapping window re-reads; a 1x1 tap still reads X once in
            # full (the kh*kw*0.5 re-read factor bottoms out at 1)
            io = xin * max(kh * kw * 0.5, 1.0) + xout + wts
            vmem = (h + kh) * (w + kw) * c * eb  # whole row-window resident
        elif algorithm == "winograd3x3":
            t = n_ * -(-oh // 2) * -(-ow // 2)
            flops = 2.0 * 16 * t * c * k / _mxu_efficiency(t, c, k) \
                + 2.0 * (16 + 16) * 4 * t * c  # transforms (VPU)
            ws = 16 * (t * c + c * k + t * k) * eb
            io = xin + xout + wts + 2 * ws
            vmem = (128 * 128 * 2) * eb + 128 * 128 * 4
        else:
            raise ValueError(algorithm)
        return OpProfile(op.name, algorithm, flops, io, ws, vmem)

    if op.kind == "pointwise":
        e = p["elements"]
        return OpProfile(op.name, "vpu", 1.0 * e, 2.0 * e * eb, 0.0,
                         128 * 1024)

    if op.kind == "maxpool":
        # the standalone pooling primitive (cuDNN pooling / XLA
        # reduce_window): each chain stage reads its input and writes the
        # pooled output — pure VPU compares, pure HBM traffic.  A chained
        # pool (pool-proj of a pooled inception module) materializes the
        # intermediate stages as workspace.  This is the launch (and the
        # pre-GEMM round-trip) the pooled grouped kernel absorbs; see
        # ``pool_profile``.
        n_, h, w, c = p["n"], p["h"], p["w"], p["c"]
        flops = io = ws = 0.0
        e_in = n_ * h * w * c
        for i, (window, stride) in enumerate(p["chain"]):
            h, w = -(-h // stride), -(-w // stride)
            e_out = n_ * h * w * c
            flops += float(window * window) * e_out
            io += (e_in + e_out) * eb
            if i < len(p["chain"]) - 1:
                ws += e_out * eb
            e_in = e_out
        return OpProfile(op.name, "reduce_window", flops, io, ws, 128 * 1024)

    raise ValueError(f"unknown op kind {op.kind}")


def op_time(op: Op, algorithm: str) -> float:
    return profile(op, algorithm).time


def best_algorithm(op: Op) -> tuple[str, float]:
    """Per-op fastest (the TF-r1.10 policy the paper critiques)."""
    algs = ALGORITHMS_BY_KIND[op.kind]
    times = {a: op_time(op, a) for a in algs if _supported(op, a)}
    a = min(times, key=times.get)
    return a, times[a]


def _supported(op: Op, algorithm: str) -> bool:
    if op.kind == "conv2d" and algorithm == "winograd3x3":
        p = op.p
        return (p["kh"], p["kw"]) == (3, 3) and p.get("stride", 1) == 1
    return True


def supported_algorithms(op: Op) -> tuple[str, ...]:
    return tuple(a for a in ALGORITHMS_BY_KIND[op.kind] if _supported(op, a))


def gemm_shape(op: Op) -> tuple[int, int, int] | None:
    """(M, K, N) if the op is expressible as ONE GEMM, else None.

    matmul ops are themselves; a conv2d is its im2col view
    (M = N*OH*OW, K = C*KH*KW, N = K_out) — the cuDNN GEMM lowering the
    paper profiles, which is what lets K×K branches join a grouped
    branch-GEMM co-execution group instead of falling back to XLA.
    """
    p = op.p
    if op.kind == "matmul":
        return p["m"], p["k"], p["n"]
    if op.kind == "conv2d":
        s = p.get("stride", 1)
        oh, ow = -(-p["h"] // s), -(-p["w"] // s)
        return p["n"] * oh * ow, p["c"] * p["kh"] * p["kw"], p["k"]
    return None


def gemm_shape_bwd(op: Op) -> tuple[tuple[int, int, int],
                                    tuple[int, int, int]] | None:
    """The op's two backward GEMMs as (M, K, N) shapes, or None.

    For a forward GEMM view (M, K, N) — convs via im2col like
    ``gemm_shape`` — the VJP computes

        dx = dY (M, N) @ W^T (N, K)      ->  (M, N, K)   shared-M ragged
        dw = X^T (K, M) @ dY (M, N)      ->  (K, M, N)   shared-M contraction

    which is why a forward co-execution group mirrors into a backward
    one: the dx GEMMs of G branches again share M, and the dw GEMMs
    share the M contraction with ragged (K_g, N_g) outputs — the two
    halves of the combined backward kernel (``grouped_matmul_bwd``).
    """
    s = gemm_shape(op)
    if s is None:
        return None
    m, k, n = s
    return (m, n, k), (k, m, n)


def backward_profiles(op: Op, algorithm: str) -> list[OpProfile]:
    """Profiles of the op's VJP computation (the Table-1 rows of the
    backward pass).

    GEMM-view ops price as their two backward GEMMs (``gemm_shape_bwd``),
    each an aligned matmul.  Pointwise grads are the same traffic shape
    (a concat backward is a split), so the forward profile stands; a
    maxpool backward is likewise ONE scatter pass of forward-equal
    traffic.  Remaining kinds use the forward profile doubled.  A KxK or
    strided conv's backward also materializes the im2col patch buffer
    both ways, charged as workspace (the C2 budget must see it); a 1x1
    stride-1 conv's backward is pure reshapes and charges nothing.
    """
    sb = gemm_shape_bwd(op)
    if sb is None:
        p = profile(op, algorithm)
        return [p] if op.kind in ("pointwise", "maxpool") else [p, p]
    profs = [profile(Op.make(f"{op.name}:{tag}", "matmul",
                             dtype_bytes=op.dtype_bytes, m=m, k=k, n=n),
                     "mxu128")
             for tag, (m, k, n) in zip(("dx", "dw"), sb)]
    kh, kw = op.p.get("kh", 1), op.p.get("kw", 1)
    stride = op.p.get("stride", 1)
    if op.kind == "conv2d" and ((kh, kw) != (1, 1) or stride != 1):
        m, k, _ = gemm_shape(op)
        ws = m * k * op.dtype_bytes
        profs = [dataclasses.replace(p, workspace_bytes=p.workspace_bytes + ws)
                 for p in profs]
    return profs


def concat_profile(join_op: Op, elements: float | None = None) -> OpProfile:
    """The fork/join concat as an explicit profile row: reading the branch
    outputs back and writing the joint buffer — 2 * elements * eb bytes of
    pure HBM traffic, zero MXU work.  ``elements`` defaults to the join
    op's full element count (the standalone-concat cost every unfused mode
    pays); the fused epilogue-concat passes only the passthrough columns
    (branch slices produced by an earlier launch), because its in-launch
    branches leave the kernel already inside the join buffer."""
    e = join_op.p["elements"] if elements is None else elements
    return OpProfile(f"{join_op.name}:concat", "concat", 0.0,
                     2.0 * e * join_op.dtype_bytes, 0.0, 0.0)


def pool_profile(op: Op) -> OpProfile:
    """The branch maxpool as an explicit profile row — the term the cost
    model used to leave invisible (the pre-GEMM ``reduce_window`` launch
    ran outside every priced group).  Standalone (unfused) plans pay this
    row as the pool op's own singleton group; when the pool is ABSORBED
    into a pooled grouped launch the rider is ZERO — the tap reads stream
    through the launch's existing lhs DMA and the pooled activation never
    touches HBM, so the whole row disappears with the launch (same shape
    as ``concat_profile``, whose fused rider keeps only the passthrough
    columns).  Calibrating the zero-rider claim on real hardware rides
    the ROADMAP's cost-model validation item."""
    assert op.kind == "maxpool", op
    return profile(op, "reduce_window")


def gemm_profiles(ops: list[Op]) -> list[OpProfile]:
    """Per-branch profiles of the GEMM lowering the grouped/stacked
    kernels execute: each op priced as its aligned ``gemm_shape`` matmul,
    with a KxK/strided conv additionally charged the im2col patch
    workspace its view materializes.  The patch buffer charges the C2
    *budget* only, not the time: layout passes around the kernel are
    modeled as riding the launch's memory traffic."""
    profs = []
    for op in ops:
        s = gemm_shape(op)
        assert s is not None, op
        m, k, n = s
        pr = profile(Op.make(f"{op.name}:gemm", "matmul",
                             dtype_bytes=op.dtype_bytes, m=m, k=k, n=n),
                     "mxu128")
        kh, kw = op.p.get("kh", 1), op.p.get("kw", 1)
        stride = op.p.get("stride", 1)
        if op.kind == "conv2d" and ((kh, kw) != (1, 1) or stride != 1):
            ws = m * k * op.dtype_bytes
            pr = dataclasses.replace(pr, workspace_bytes=pr.workspace_bytes + ws)
        profs.append(pr)
    return profs


def _passthrough_elements(shapes, join_op: Op) -> float:
    """Join elements NOT produced by the group's own branch GEMMs — the
    columns a fused epilogue-concat still has to copy in."""
    own = sum(m * n for m, _, n in shapes)
    return max(join_op.p["elements"] - own, 0.0)


def group_execution_time_bwd(ops: list[Op], algorithms: dict | None = None,
                             mode: str | None = None,
                             join: Op | None = None) -> tuple[str, float]:
    """(realizable mode, modeled makespan) for the grad group mirroring a
    forward co-execution group — the backward analogue of
    ``group_execution_time``, and what the autograd Functions launch.

    Branches with shared-M GEMM views backward-co-execute in ONE combined
    grouped launch (masked dx + dw/db) or, for uniform shapes, two
    stacked ones.  Anything else only has the per-op pullback, priced
    with the interleave loss.  ``mode`` forces the pricing to a known
    forward mode (``plan.backward_plan`` passes the lowered mode; the
    scheduler omits it to judge candidates).  ``join`` + mode=
    "grouped_concat" prices the grad of a fused epilogue-concat group:
    only the passthrough columns pay the split's read+write.
    """
    algs = algorithms or {}

    def bprofs(op):
        return backward_profiles(
            op, algs.get(op.name) or best_algorithm(op)[0])

    if len(ops) == 1:
        return "serial", sum(p.time for p in bprofs(ops[0]))
    shapes = [gemm_shape(op) for op in ops]
    grouped_ok = (all(s is not None for s in shapes)
                  and len({s[0] for s in shapes}) == 1)
    if grouped_ok and mode in ("grouped", "grouped_pooled",
                               "grouped_concat", "stacked", None):
        per_op = [bprofs(op) for op in ops]
        dxp = [p[0] for p in per_op]
        dwp = [p[1] for p in per_op]
        if mode == "grouped_concat":
            if join is None:
                raise ValueError("grouped_concat backward needs the join")
            rider = concat_profile(join, _passthrough_elements(shapes, join))
            return "grouped_concat", co_execution_time(dxp + dwp + [rider])
        # ONE combined launch: compute of one half overlaps memory of the
        # other across the whole union
        t_grouped = co_execution_time(dxp + dwp)
        uniform = len({s[:2] for s in shapes}) == 1
        # a forced stacked mode prices pad-to-max even on ragged branches;
        # the auto choice (mode=None) prefers stacked only on uniform
        # shapes, like the forward judgement
        if mode == "stacked" or (uniform and mode is None):
            dx_shapes = [(m, n, k) for m, k, n in shapes]
            dw_shapes = [(k, m, n) for m, k, n in shapes]
            t_stacked = (stacked_time(dxp, dx_shapes)
                         + stacked_time(dwp, dw_shapes))
            if mode == "stacked" or t_stacked <= t_grouped:
                return "stacked", t_stacked
        # a pooled forward mirrors to the SAME combined launch (the pool
        # cotangent routes in its unpacking: zero rider)
        return ("grouped_pooled" if mode == "grouped_pooled"
                else "grouped"), t_grouped
    flat = [p for op in ops for p in bprofs(op)]
    return "xla", xla_interleave_time(flat)


def co_execution_time(profiles: list[OpProfile]) -> float:
    """Modeled makespan of a co-execution group on ONE chip.

    Fused/batched ops share the chip: MXU work serializes across the group,
    HBM traffic serializes across the group, but compute of one op overlaps
    memory traffic of another (DMA/MXU pipelining) — so the group finishes at
    max(sum_compute, sum_memory) instead of sum(max(c_i, m_i)).
    Complementary groups (compute-bound + memory-bound) win; same-bound
    groups don't — exactly the paper's Table-1 observation.  The lone-kernel
    pipeline-loss term amortizes by the group size: other branches' blocks
    fill the bubbles one op's intra-dependencies leave.
    """
    c = sum(pr.compute_time for pr in profiles)
    m = sum(pr.memory_time for pr in profiles)
    return max(c, m) + PROFILE.pipeline_loss * min(c, m) / len(profiles)


def serial_time(profiles: list[OpProfile]) -> float:
    return sum(pr.time for pr in profiles)


def grouped_time(ops: list[Op]) -> float:
    """Makespan of a grouped ragged branch GEMM (kernels/grouped_matmul):
    every branch runs only its own alignment-padded tiles, so there is no
    padding-waste term — the group is pure co-execution, priced directly
    off the ``gemm_shape`` lowering the kernel executes
    (``gemm_profiles``; was the scheduler-chosen per-op algorithm
    profiles — a proxy whose drift the docstring used to acknowledge).
    Calibrating against hardware stays a ROADMAP open item."""
    return co_execution_time(gemm_profiles(ops))


def stacked_time(profiles: list[OpProfile],
                 shapes: list[tuple[int, int, int]]) -> float:
    """Makespan of the pad-to-max stacked kernel (kernels/branch_matmul):
    every branch's MXU grid is inflated to the widest branch's aligned
    (K, N), so branch g pays round128(Kmax)*round128(Nmax) /
    (round128(K_g)*round128(N_g)) of its own compute.  (Memory traffic is
    dominated by the shared-M inputs; padded tiles are modeled as noise.)
    ``profiles`` should be the ``gemm_profiles`` of the branches — the
    stacked kernel executes the same GEMM lowering the grouped one does,
    just padded (``group_execution_time`` prices both arms off it)."""
    def al(d):
        return -(-d // 128) * 128
    kmax = max(al(k) for _, k, _ in shapes)
    nmax = max(al(n) for _, _, n in shapes)
    c = sum(pr.compute_time * (kmax * nmax) / (al(k) * al(n))
            for pr, (_, k, n) in zip(profiles, shapes))
    m = sum(pr.memory_time for pr in profiles)
    return max(c, m) + PROFILE.pipeline_loss * min(c, m) / len(profiles)


def padded_m_factor(m_true: int, m_bucket: int, *, bm: int = 128) -> float:
    """Padded-M waste of serving a ragged request mix through an M-bucket:
    the grouped grid runs ``ceil(M_bucket/bm)`` row-blocks regardless of
    how many rows are real, so a mix with ``m_true`` true rows pays
    ``al(M_bucket)/al(m_true)`` of its useful compute (the same
    aligned-tile inflation idiom ``stacked_time`` prices pad-to-max
    branches with — M is just the dimension being padded here).  1.0 means
    the bucket is free for this mix."""
    def al(d):
        return max(-(-d // bm) * bm, bm)
    return al(m_bucket) / al(m_true)


def serve_buckets(max_images: int, rows_per_image: int, *,
                  bm: int = 128) -> list[int]:
    """The serving loop's M-bucket ladder, a MODELED decision: start
    from powers-of-two image counts up to ``max_images`` and merge any
    bucket whose worst-case padded-M factor over the next bucket is 1.0 —
    when ``rows_per_image`` image-rows already tile the bm-aligned grid
    identically for both bucket sizes (every googlenet group has
    rows_per_image a multiple of bm once H*W*B aligns), the smaller bucket
    buys no fewer row-blocks and only fragments the plan/executable cache.
    The surviving ladder is exactly the set of bucket sizes whose grids
    actually differ."""
    assert max_images >= 1 and rows_per_image >= 1
    ladder = []
    b = 1
    while b < max_images:
        ladder.append(b)
        b *= 2
    ladder.append(max_images)
    kept = []
    for lo, hi in zip(ladder, ladder[1:]):
        # worst case inside bucket `hi` but servable by `lo`: m_true =
        # lo * rows_per_image.  If hi's grid is no bigger, lo is redundant.
        if padded_m_factor(lo * rows_per_image, hi * rows_per_image,
                           bm=bm) > 1.0:
            kept.append(lo)
    kept.append(ladder[-1])
    return kept


def xla_interleave_time(profiles: list[OpProfile]) -> float:
    co = co_execution_time(profiles)
    return co + PROFILE.xla_interleave_loss * (serial_time(profiles) - co)


def group_execution_time(ops: list[Op], profiles: list[OpProfile],
                         join: Op | None = None) -> tuple[str, float]:
    """(realizable single-chip mode, modeled makespan) for a co-execution
    group — the shared judgement ``scheduler`` packs with and
    ``plan.lower`` turns into an ExecGroup.

    Branches expressible as shared-M GEMMs co-execute as one grouped
    (ragged) or stacked (uniform-shape) kernel; a compute+memory
    complementary (GEMM, pointwise) pair fuses; anything else only has the
    XLA-interleave path, modeled with its overlap loss.

    ``join``: the fork/join concat this group's outputs feed, when the
    caller wants the concat traffic priced WITH the group (the absorption
    judgement in ``plan.lower``).  A grouped group then becomes
    ``grouped_concat`` — the fused epilogue-concat writes branch slices
    in place, so only the passthrough columns keep their copy cost
    (``concat_profile``) — while any other mode pays the standalone
    concat's full read+write on top (the term the join's own singleton
    group prices when it is NOT absorbed; never count both).
    """
    if len(ops) == 1:
        return "serial", profiles[0].time
    shapes = [gemm_shape(op) for op in ops]
    if all(s is not None for s in shapes) \
            and len({s[0] for s in shapes}) == 1:
        # grouped/stacked price off the GEMM lowering the kernels execute
        # (gemm_profiles), not the serial path's chosen algorithms
        gprofs = gemm_profiles(ops)
        if join is not None:
            rider = concat_profile(join, _passthrough_elements(shapes, join))
            return "grouped_concat", co_execution_time(gprofs + [rider])
        t_grouped = co_execution_time(gprofs)
        if len({s[:2] for s in shapes}) == 1:   # uniform (M, K): stackable
            t_stacked = stacked_time(gprofs, shapes)
            if t_stacked <= t_grouped:
                return "stacked", t_stacked
        return "grouped", t_grouped
    if join is not None:
        mode, t = group_execution_time(ops, profiles)
        return mode, t + concat_profile(join).time
    gemm = [i for i, s in enumerate(shapes) if s is not None]
    stream = [i for i, op in enumerate(ops) if op.kind == "pointwise"]
    if (len(ops) == 2 and len(gemm) == 1 and len(stream) == 1
            and gemm[0] != stream[0]
            and profiles[gemm[0]].bound == "compute"
            and profiles[stream[0]].bound == "memory"):
        return "fused", co_execution_time(profiles)
    return "xla", xla_interleave_time(profiles)


# ---------------------------------------------------------------------------
# chained launches (cross-module streaming)
# ---------------------------------------------------------------------------

def chained_profiles(ops: list[Op], ring=frozenset()) -> list[OpProfile]:
    """``gemm_profiles`` with ring-consumer branches repriced for the
    chained launch: a branch whose lhs streams from the in-kernel VMEM
    ring (its producer runs one wave ahead in the SAME launch) never
    reads its input activation from HBM and never materializes an im2col
    patch buffer — drop the M*K lhs read from traffic and the patch
    workspace from the C2 budget.  Every other term (weights, bias,
    output write) stands: chained outputs still land in HBM as the next
    launch's panel operands."""
    ring = frozenset(ring)
    profs = []
    for op, pr in zip(ops, gemm_profiles(ops)):
        if op.name in ring:
            s = gemm_shape(op)
            assert s is not None, op
            m, k, _ = s
            lhs = m * k * op.dtype_bytes
            pr = dataclasses.replace(
                pr,
                hbm_bytes=max(pr.hbm_bytes - lhs, 0.0),
                workspace_bytes=max(pr.workspace_bytes - lhs, 0.0))
        profs.append(pr)
    return profs


def chained_time(phase_ops: list[list[Op]], ring=frozenset(),
                 m_valid: int | None = None) -> float:
    """Modeled makespan of ONE chained launch over ``phase_ops`` (one op
    list per phase, Shi-et-al.-style honest pricing rather than
    assertion): the union co-executes like one big grouped launch —
    MXU work and HBM traffic serialize across ALL branches of ALL
    phases, compute overlapping memory — with ring consumers' lhs
    traffic dropped (``chained_profiles``) and NO concat rider (the next
    launch consumes the padded panels in place via its lhs-source
    descriptors).  On top rides the pipeline-FILL term the wave schedule
    costs: a P-phase chain runs mb + P - 1 waves for mb row blocks, so
    the steady-state makespan stretches by (P-1)/(mb+P-1).

    ``m_valid`` prices the ragged serving launch: dead M-blocks past the
    cutoff are skipped as no-op waves, so the steady-state work scales
    by the live-block fraction and the fill term runs over live blocks
    only (the no-op waves cost grid steps, not GEMMs — negligible next
    to a block's tap-GEMM ladder, so the model drops them)."""
    ops = [op for ph in phase_ops for op in ph]
    t = co_execution_time(chained_profiles(ops, ring))
    m = max(gemm_shape(op)[0] for op in ops)
    mb = max(-(-m // 128), 1)
    if m_valid is not None:
        mbl = min(max(-(-m_valid // 128), 1), mb)
        t *= mbl / mb
        mb = mbl
    nph = len(phase_ops)
    return t * (1.0 + (nph - 1) / (mb + nph - 1))


def chained_time_bwd(phase_ops: list[list[Op]],
                     algorithms: dict | None = None) -> float:
    """Backward makespan of a chained launch: the VJP mirrors the chain
    in reverse phase order with one combined grouped launch (masked dx +
    dw/db) per phase — a ring consumer's lhs cotangent feeds the
    producer phase's dy, so phases cannot backward-co-execute.  No
    traffic is dropped: ring consumers' lhs is recomputed from the
    residual panels."""
    algs = algorithms or {}
    total = 0.0
    for ops in phase_ops:
        per = [backward_profiles(op, algs.get(op.name)
                                 or best_algorithm(op)[0])
               for op in ops]
        total += co_execution_time([p[0] for p in per]
                                   + [p[1] for p in per])
    return total
