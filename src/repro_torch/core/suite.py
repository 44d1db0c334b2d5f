"""Synthetic 110-matrix evaluation suite.

SuiteSparse is not reachable offline, so the suite regenerates — with seeded
determinism — the structural families the paper's selection criteria target
(§4.1): FEM/banded meshes, block-diagonal systems, power-law graphs,
road-network-style lattices, Erdős–Rényi noise, Kronecker/RMAT graphs,
community ("caveman") graphs and hub-and-spoke graphs. Each structured family
also ships a *scrambled* variant (random symmetric permutation) — real
SuiteSparse inputs arrive in orders of very mixed quality, and scrambled
variants are what make reordering recoverable rather than vacuous.

Sizes are scaled to this container (CPU, jitted-JAX timing) while keeping the
structural diversity; the generator is parameterized so the same code scales
to paper-sized inputs on real hardware.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np

from repro_torch.core.formats import HostCSR

__all__ = ["MatrixSpec", "SUITE", "generate", "iter_suite", "suite_names"]


@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    name: str
    family: str
    generator: Callable[..., HostCSR]
    kwargs: dict
    scrambled: bool = False


# ---------------------------------------------------------------------------
# generators — all return symmetric-pattern square HostCSR with unit values
# ---------------------------------------------------------------------------


def _sym_coo(n: int, rows, cols, rng) -> HostCSR:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    r = np.concatenate([rows, cols, np.arange(n)])
    c = np.concatenate([cols, rows, np.arange(n)])
    v = rng.uniform(0.5, 1.5, size=r.shape[0]).astype(np.float32)
    return HostCSR.from_coo(r, c, v, (n, n))


def gen_mesh2d(side: int, seed: int = 0, stencil: int = 5) -> HostCSR:
    """2-D grid Laplacian pattern (5- or 9-point) — FEM-mesh-like."""
    rng = np.random.default_rng(seed)
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    idx = (ii * side + jj).ravel()
    rows, cols = [], []
    offsets = [(0, 1), (1, 0)]
    if stencil == 9:
        offsets += [(1, 1), (1, -1)]
    for di, dj in offsets:
        ni, nj = ii + di, jj + dj
        ok = (ni >= 0) & (ni < side) & (nj >= 0) & (nj < side)
        rows.append(idx.reshape(side, side)[ok])
        cols.append((ni * side + nj)[ok])
    return _sym_coo(n, np.concatenate(rows), np.concatenate(cols), rng)


def gen_banded(n: int, band: int, fill: float = 0.6, seed: int = 0) -> HostCSR:
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for d in range(1, band + 1):
        m = n - d
        keep = rng.random(m) < fill
        r = np.arange(m)[keep]
        rows.append(r)
        cols.append(r + d)
    return _sym_coo(n, np.concatenate(rows), np.concatenate(cols), rng)


def gen_block_diag(n: int, block: int, inter: float = 0.001,
                   seed: int = 0) -> HostCSR:
    """Dense diagonal blocks + sparse inter-block noise (paper §3.2's
    motivating structure for fixed-length clustering)."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for b0 in range(0, n, block):
        sz = min(block, n - b0)
        r, c = np.meshgrid(np.arange(sz), np.arange(sz), indexing="ij")
        keep = (r < c) & (rng.random((sz, sz)) < 0.7)
        rows.append(b0 + r[keep])
        cols.append(b0 + c[keep])
    m = int(inter * n * n)
    if m:
        rows.append(rng.integers(0, n, m))
        cols.append(rng.integers(0, n, m))
    return _sym_coo(n, np.concatenate(rows), np.concatenate(cols), rng)


def gen_powerlaw(n: int, avg_deg: int = 12, seed: int = 0) -> HostCSR:
    """Preferential-attachment (Barabási–Albert-style) power-law graph."""
    rng = np.random.default_rng(seed)
    m = max(1, avg_deg // 2)
    targets = list(range(m))
    rows, cols = [], []
    repeated: list[int] = list(range(m))
    for v in range(m, n):
        picks = rng.choice(len(repeated), size=m, replace=True)
        chosen = {repeated[p] for p in picks}
        for u in chosen:
            rows.append(v)
            cols.append(u)
            repeated.extend((v, u))
    return _sym_coo(n, rows, cols, rng)


def gen_road(side: int, extra: float = 0.05, seed: int = 0) -> HostCSR:
    """Long-diameter lattice with sparse shortcuts — road-network-like."""
    rng = np.random.default_rng(seed)
    g = gen_mesh2d(side, seed=seed, stencil=5)
    n = side * side
    m = int(extra * n)
    r = rng.integers(0, n, m)
    c = np.clip(r + rng.integers(-3 * side, 3 * side, m), 0, n - 1)
    rows = np.concatenate([np.repeat(np.arange(n), g.row_nnz()), r])
    cols = np.concatenate([g.indices.astype(np.int64), c])
    return _sym_coo(n, rows, cols, rng)


def gen_er(n: int, avg_deg: int = 10, seed: int = 0) -> HostCSR:
    rng = np.random.default_rng(seed)
    m = n * avg_deg // 2
    return _sym_coo(n, rng.integers(0, n, m), rng.integers(0, n, m), rng)


def gen_kron(scale: int, edge_factor: int = 10, seed: int = 0) -> HostCSR:
    """RMAT/Kronecker generator (Graph500 parameters)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    a_, b_, c_ = 0.57, 0.19, 0.19
    rows = np.zeros(m, dtype=np.int64)
    cols = np.zeros(m, dtype=np.int64)
    for lvl in range(scale):
        r = rng.random(m)
        bit_r = (r > a_ + b_).astype(np.int64)
        r2 = rng.random(m)
        thr = np.where(bit_r == 0, b_ / (a_ + b_), (1 - a_ - b_ - c_)
                       / max(1 - a_ - b_, 1e-9))
        bit_c = (r2 < thr).astype(np.int64)
        rows |= bit_r << lvl
        cols |= bit_c << lvl
    return _sym_coo(n, rows, cols, rng)


def gen_caveman(n: int, cave: int = 24, rewire: float = 0.05,
                seed: int = 0) -> HostCSR:
    """Connected-caveman communities — Rabbit Order's target structure."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for b0 in range(0, n, cave):
        sz = min(cave, n - b0)
        r, c = np.meshgrid(np.arange(sz), np.arange(sz), indexing="ij")
        keep = (r < c) & (rng.random((sz, sz)) < 0.6)
        rows.append(b0 + r[keep])
        cols.append(b0 + c[keep])
    m = int(rewire * n)
    rows.append(rng.integers(0, n, m))
    cols.append(rng.integers(0, n, m))
    return _sym_coo(n, np.concatenate(rows), np.concatenate(cols), rng)


def gen_hubspoke(n: int, hubs: int = 12, spoke_deg: int = 3,
                 seed: int = 0) -> HostCSR:
    """Few high-degree hubs + sparse periphery — SlashBurn's target."""
    rng = np.random.default_rng(seed)
    hub_ids = rng.choice(n, hubs, replace=False)
    rows, cols = [], []
    for v in range(n):
        deg = spoke_deg if v not in hub_ids else 0
        tgt = rng.choice(hub_ids, size=min(deg, hubs), replace=False)
        rows.extend([v] * tgt.size)
        cols.extend(tgt.tolist())
    m = n // 2
    rows.extend(rng.integers(0, n, m).tolist())
    cols.extend(rng.integers(0, n, m).tolist())
    return _sym_coo(n, rows, cols, rng)


def _scramble(a: HostCSR, seed: int) -> HostCSR:
    rng = np.random.default_rng(seed + 7777)
    perm = rng.permutation(a.nrows)
    return a.permute_symmetric(perm)


# ---------------------------------------------------------------------------
# the suite: 110 entries
# ---------------------------------------------------------------------------


def _build_specs() -> list[MatrixSpec]:
    specs: list[MatrixSpec] = []

    def add(name, family, gen, scramble_too=True, **kw):
        specs.append(MatrixSpec(name, family, gen, kw, scrambled=False))
        if scramble_too:
            specs.append(MatrixSpec(name + "_scr", family, gen, kw,
                                    scrambled=True))

    # FEM/mesh family (like AS365, M6, NLR) — 7 natural + 7 scrambled
    for i, side in enumerate((24, 32, 40, 48, 56, 64, 72)):
        add(f"mesh2d_{side}", "mesh", gen_mesh2d, side=side, seed=i,
            stencil=5 if i % 2 == 0 else 9)
    # banded (solver matrices) — 6 + 6
    for i, (n, band) in enumerate(((1024, 4), (2048, 6), (3072, 8),
                                   (4096, 10), (2048, 16), (3072, 24))):
        add(f"band_{n}_{band}", "banded", gen_banded, n=n, band=band, seed=i)
    # block-diagonal (circuit/optimization) — 6 + 6
    for i, (n, blk) in enumerate(((1024, 8), (2048, 8), (2048, 16),
                                  (3072, 12), (4096, 8), (4096, 24))):
        add(f"blkdiag_{n}_{blk}", "blockdiag", gen_block_diag,
            n=n, block=blk, seed=i)
    # power-law (social/web) — 6 + 6
    for i, (n, d) in enumerate(((1024, 10), (2048, 12), (3072, 10),
                                (4096, 12), (2048, 20), (4096, 8))):
        add(f"plaw_{n}_{d}", "powerlaw", gen_powerlaw, n=n, avg_deg=d, seed=i)
    # road-like lattices — 5 + 5
    for i, side in enumerate((32, 40, 48, 56, 64)):
        add(f"road_{side}", "road", gen_road, side=side, seed=i)
    # Erdős–Rényi — 5 (no scrambled variant: ER is permutation-invariant)
    for i, (n, d) in enumerate(((1024, 8), (2048, 10), (3072, 8),
                                (4096, 10), (2048, 16))):
        add(f"er_{n}_{d}", "er", gen_er, scramble_too=False,
            n=n, avg_deg=d, seed=i)
    # Kronecker/RMAT — 4 + 4
    for i, (scale, ef) in enumerate(((10, 8), (11, 8), (12, 8), (11, 16))):
        add(f"kron_{scale}_{ef}", "kron", gen_kron, scale=scale,
            edge_factor=ef, seed=i)
    # caveman communities — 5 + 5
    for i, (n, cave) in enumerate(((1024, 16), (2048, 24), (3072, 24),
                                   (4096, 32), (2048, 48))):
        add(f"cave_{n}_{cave}", "caveman", gen_caveman, n=n, cave=cave, seed=i)
    # hub-and-spoke — 4 + 4
    for i, (n, hubs) in enumerate(((1024, 8), (2048, 12), (3072, 16),
                                   (4096, 16))):
        add(f"hub_{n}_{hubs}", "hubspoke", gen_hubspoke, n=n, hubs=hubs,
            seed=i)
    # mixed extras to land exactly on 110
    add("mesh2d_80", "mesh", gen_mesh2d, side=80, seed=99, stencil=5)
    add("plaw_3072_16", "powerlaw", gen_powerlaw, n=3072, avg_deg=16, seed=91)
    add("band_5120_12", "banded", gen_banded, n=5120, band=12, seed=92)
    add("cave_5120_40", "caveman", gen_caveman, n=5120, cave=40, seed=93)
    add("road_72", "road", gen_road, side=72, seed=95)
    add("kron_12_16", "kron", gen_kron, scale=12, edge_factor=16, seed=96)
    add("blkdiag_5120_16", "blockdiag", gen_block_diag, n=5120, block=16,
        seed=97)
    add("hub_5120_24", "hubspoke", gen_hubspoke, n=5120, hubs=24, seed=98)
    specs.append(MatrixSpec("mesh2d_96", "mesh", gen_mesh2d,
                            dict(side=96, seed=89, stencil=5)))
    specs.append(MatrixSpec("er_5120_12", "er", gen_er,
                            dict(n=5120, avg_deg=12, seed=94)))
    specs.append(MatrixSpec("er_3072_14", "er", gen_er,
                            dict(n=3072, avg_deg=14, seed=88)))
    return specs


SUITE: list[MatrixSpec] = _build_specs()
assert len(SUITE) == 110, f"suite has {len(SUITE)} entries, want 110"


def generate(spec: MatrixSpec) -> HostCSR:
    a = spec.generator(**spec.kwargs)
    if spec.scrambled:
        a = _scramble(a, seed=spec.kwargs.get("seed", 0))
    return a


def suite_names() -> list[str]:
    return [s.name for s in SUITE]


def iter_suite(names: list[str] | None = None,
               limit: int | None = None) -> Iterator[tuple[MatrixSpec, HostCSR]]:
    count = 0
    for spec in SUITE:
        if names is not None and spec.name not in names:
            continue
        yield spec, generate(spec)
        count += 1
        if limit is not None and count >= limit:
            return
