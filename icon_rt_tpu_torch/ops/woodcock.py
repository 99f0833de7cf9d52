"""Woodcock (delta) tracking against a constant majorant, batched over
lanes: the plain version of the AE raygen's tracking loop inside kernel K8
(csrc/parity.cu), and the lock-step loop that the traversals of
ops/traverse.py share.

Port of the reference's free-flight sampling loop
(ref: icon_rt/deviceCode.cu:149-186).  One iteration is one tentative
collision.  RNG discipline, as in the reference: each iteration draws the
flight distance, and draws the acceptance uniform ONLY if the point lies
before the segment end and inside a cell.

`Work` counts what a plain run does, event by event, for the bound of
K8 in chip_smoke.py; the loops take one where the caller asks for it.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..models.cells import (_BRUTE_CHUNK, Cells, _radius, candidate_tests,
                            in_shell)
from ..models.locator import Locator, locator_rows
from ..models.wedges import Wedges, in_wedge_shell, wedge_candidates
from ..utils.lcg import lcg_next

#: iteration cap of the tracking loops (the JAX traversals' max_iters); no
#: lane of the tests or of chip_smoke.py comes near it
MAX_ITERS = 1 << 20
#: iterations between two compactions of the lock-step loop on a GPU: each
#: compaction reads the live count on the host; between two of them the
#: loop replays a CUDA graph of one iteration (on the CPU it runs eagerly
#: and compacts every iteration)
COMPACT_EVERY = 128
#: draws a lock-step iteration of `woodcock_track` may take past samples
#: that the sampler's shell test rejects before its one full sample
SKIP_DRAWS = 8


def _window(state: dict, live, step_fn: Callable, n: int, graph: bool):
    """n lock-step iterations on fixed rows, updating `state` and `live` in
    place.  With `graph`, the first runs eagerly and the rest replay a CUDA
    graph of one iteration captured on the rows' shapes (the loop body has
    no host sync), which takes the host's per-operation cost out of the
    loop."""
    def iterate():
        updates, done = step_fn(state, live)
        updates.setdefault("steps", state["steps"] + 1)
        for k, v in updates.items():
            m = live.view(-1, *([1] * (v.dim() - 1)))
            state[k].copy_(torch.where(m, v, state[k]))
        live.copy_(live & ~done)

    iterate()
    if n < 2:
        return
    if not graph:
        for _ in range(n - 1):
            iterate()
        return
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        g.capture_begin()
        iterate()
        g.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(n - 1):
        g.replay()
    g.reset()


def lockstep(state: dict, ids, step_fn: Callable, out: dict,
             max_iters: int = MAX_ITERS) -> None:
    """Run `step_fn` in lock step over the rows of `state` (per-row tensors
    of the live lanes `ids`, with a "steps" counter) until each row is done.

    step_fn(state, live) -> (updates, done): new values of some state
    keys for every row (its "steps" where it takes more than one step) and
    the rows that finish with this iteration; it must not sync with the
    host.  A row takes its updates only while it is live, so
    a finished row keeps its final state until the next compaction writes
    the keys of `out` (full-lane tensors) and "steps" back to its lane and
    drops it.  After max_iters iterations the rows still live are written
    back as they are."""
    state = {k: v.clone() for k, v in state.items()}   # no shared storage
    live = torch.ones(ids.shape[0], dtype=torch.bool, device=ids.device)
    eager = ids.device.type != "cuda"
    every = 1 if eager else COMPACT_EVERY
    it = 0
    while ids.numel():
        n = min(every, max_iters - it)
        _window(state, live, step_fn, n, not eager)
        it += n
        fin = ~live if it < max_iters else torch.ones_like(live)
        for k, v in out.items():
            v[ids[fin]] = state[k][fin].to(v.dtype)
        keep = ~fin
        ids, live = ids[keep], live[keep]
        state = {k: v[keep] for k, v in state.items()}


def make_shell_fn(cells: Cells, sampler: str,
                  wedges: Wedges | None = None):
    """The sampler's whole-shell test, batched over lanes: pos (L, 3) ->
    (L,) bool, False where no cell (with the wedge sampler: no wedge) can
    contain the point -- K8's pre-test before the locate
    (models/cells.py `in_shell`, models/wedges.py `in_wedge_shell`)."""
    if sampler == "wedge":
        return lambda pos: in_wedge_shell(wedges, pos)
    return lambda pos: in_shell(cells, _radius(pos))


class Work:
    """Event counts of a plain parity run and the table entries it reads:
    what kernel K8 does for the same lanes, since it makes the same draws
    and tests (its final rng and iterations are held equal lane by lane).

    Counts (`n`, in EVENTS order): "draw" free-path draws, "advance"
    traversal advances, "eval" point samples, then the candidate tests of
    the first-match scan by where each stops -- "radial" (the radius
    compare), "plane1".."plane3" (the first failing plane), "hit" (the
    containing cell; one per sample that finds a cell) -- and
    "hit_layers", the layers of the hit cells (their layer select).  The
    wedge sampler instead counts, up to its first hit, "wcol" the
    candidate columns it visits, "wcol_layers" their layer counts (each
    visit's find_layer), "newton" the wedges it inverts and
    "newton_iters" their Newton iterations, and "hit".  "shell" counts the
    samples that the whole-shell test rejects (the cells' shell, or the
    wedges'), whose locate and scan are not counted.  The masks mark the
    cells whose radii, planes and layer rows were read (with the wedge
    sampler: the visited columns' heights and the inverted wedges) and
    the locator entries read.  Counting adds no host sync and no host copy
    to the loop (which a CUDA graph captures)."""

    EVENTS = ("draw", "advance", "eval", "radial", "plane1", "plane2",
              "plane3", "hit", "hit_layers", "wcol", "wcol_layers",
              "newton", "newton_iters", "shell")

    def __init__(self, cells: Cells, sampler: str,
                 locator: Locator | None = None,
                 wedges: Wedges | None = None):
        dev = cells.planes.device
        n = cells.num_cells
        self.cells, self.sampler, self.locator = cells, sampler, locator
        self.wedges = wedges
        self.in_shell = make_shell_fn(cells, sampler, wedges)
        self.n = torch.zeros(len(self.EVENTS), dtype=torch.int64, device=dev)
        # one spare slot each takes the writes of the lanes not counted
        flag = lambda k: torch.zeros(k + 1, dtype=torch.bool, device=dev)
        self.radial_read, self.planes_read, self.hit_read = (
            flag(n), flag(n), flag(n))
        if sampler in ("locator", "wedge"):
            self.dims = tuple(int(d) for d in locator.dims.tolist())
            self.entries_read = flag(locator.bins.numel())
        if sampler == "wedge":
            self.wedge_read = flag(wedges.verts.shape[0])

    def add(self, event: str, rows) -> None:
        """Count `event` once for each True of `rows`, or `rows` times."""
        i = self.EVENTS.index(event)
        self.n[i:i + 1] += rows.sum()

    def sample(self, pos, mask) -> None:
        """Count one sample at pos (L, 3) for the rows of `mask`: the
        whole-shell test (the cells' shell, or with the wedge sampler the
        wedges'), then for the rows that pass it the locate and every
        candidate test up to the first containing cell or wedge."""
        self.add("eval", mask)
        inner = self.in_shell(pos)
        self.add("shell", mask & ~inner)
        mask = mask & inner
        if self.sampler == "wedge":
            self._wedge_scan(pos, mask)
            return
        if self.sampler == "locator":
            r, row = locator_rows(self.locator, pos, self.dims)
            k = self.locator.bins.shape[1]
            slots = row[:, None] * k + torch.arange(k, device=pos.device)
            self._scan(self.locator.bins[row], pos, r, mask, slots)
            return
        r = _radius(pos)
        step = max(1, _BRUTE_CHUNK // max(self.cells.num_cells, 1))
        for a in range(0, pos.shape[0], step):
            m = slice(a, a + step)
            self._scan(None, pos[m], r[m], mask[m], None)

    def _scan(self, cand, pos, r, mask, slots) -> None:
        """The first-match scan over candidates cand (L, K) (-1 pads the
        tail; None: every cell in id order), as the kernel runs it: the
        radial compare, then the planes in order, each test stopping at
        its first failure."""
        n = self.cells.num_cells
        if cand is None:
            idx = torch.arange(n, device=pos.device)[None, :]
            radial, planes = candidate_tests(self.cells, None, pos, r)
            valid = torch.ones_like(radial)
        else:
            idx = torch.clamp(cand, min=0).long()
            radial, planes = candidate_tests(self.cells, idx, pos, r)
            valid = cand >= 0
        inside = valid & radial & planes.all(dim=-1)
        before = torch.cumsum(inside.to(torch.int32), dim=1) \
            - inside.to(torch.int32)
        tested = valid & (before == 0) & mask[:, None]
        stop = torch.where(~radial, 0, torch.where(
            ~planes[..., 0], 1, torch.where(~planes[..., 1], 2, torch.where(
                ~planes[..., 2], 3, 4))))
        self.n[3:8] += torch.stack([(tested & (stop == k)).sum()
                                    for k in range(5)])
        hit = tested & inside
        self.add("hit_layers", torch.where(
            hit, self.cells.num_layers[idx], 0))
        for read, m in ((self.radial_read, tested),
                        (self.planes_read, tested & radial),
                        (self.hit_read, hit)):
            if cand is None:
                read[:n] |= m.any(dim=0)
            else:
                read.index_fill_(0, torch.where(m, idx, n).reshape(-1), True)
        if slots is not None:
            # the entries tested and, after a scan without a hit, the -1
            # that ends it
            miss = mask & ~inside.any(dim=1)
            first_pad = ~valid & (torch.cumsum((~valid).to(torch.int32),
                                               dim=1) == 1)
            read = tested | (first_pad & miss[:, None])
            spare = self.entries_read.shape[0] - 1
            self.entries_read.index_fill_(
                0, torch.where(read, slots, spare).reshape(-1), True)

    def _wedge_scan(self, pos, mask) -> None:
        """The wedge sampler's scan as the kernel runs it: the candidate
        columns in bin order, in each the window's in-range wedges upward,
        up to the first inversion that contains the point."""
        c = wedge_candidates(self.cells, self.wedges, self.locator, pos,
                             self.dims)
        cand, hit, in_range = c["cand"], c["hit"], c["in_range"]
        L, K, pad = hit.shape
        valid = cand >= 0
        idx = torch.clamp(cand, min=0).long()
        flat = hit.reshape(L, K * pad).to(torch.int32)
        tested = (in_range.reshape(L, K * pad)
                  & (torch.cumsum(flat, dim=1) - flat == 0)
                  & mask[:, None])
        col_hit = hit.any(dim=2).to(torch.int32)
        visited = valid & (torch.cumsum(col_hit, dim=1) - col_hit == 0) \
            & mask[:, None]
        it = c["iters"].reshape(L, K * pad).to(torch.int64)
        i = self.EVENTS.index("wcol")
        self.n[i:i + 4] += torch.stack([
            visited.sum(),
            torch.where(visited, self.cells.num_layers[idx], 0).sum(),
            tested.sum(), torch.where(tested, it, 0).sum()])
        got = mask & hit.reshape(L, -1).any(dim=1)
        self.add("hit", got)
        n = self.cells.num_cells
        self.hit_read.index_fill_(0, torch.where(visited, idx, n).reshape(-1),
                                  True)
        spare = self.wedge_read.shape[0] - 1
        self.wedge_read.index_fill_(
            0, torch.where(tested, c["wid"].reshape(L, -1), spare).reshape(-1),
            True)
        # the entries visited and, after a scan without a hit, the -1 that
        # ends it
        r, row = locator_rows(self.locator, pos, self.dims)
        slots = row[:, None] * K + torch.arange(K, device=pos.device)
        first_pad = ~valid & (torch.cumsum((~valid).to(torch.int32),
                                           dim=1) == 1)
        read = visited | (first_pad & (mask & ~got)[:, None])
        self.entries_read.index_fill_(
            0, torch.where(read, slots, self.entries_read.shape[0] - 1
                           ).reshape(-1), True)

    def counts(self) -> dict:
        """The counts by event and the reads (one host read)."""
        c = dict(zip(self.EVENTS, self.n.tolist()))
        read = self.hit_read[:-1]
        c.update(radial_cells=int(self.radial_read[:-1].sum()),
                 plane_cells=int(self.planes_read[:-1].sum()),
                 hit_cells=int(read.sum()),
                 hit_cell_layers=int(self.cells.num_layers[read].sum()),
                 entries=int(self.entries_read[:-1].sum())
                 if self.sampler in ("locator", "wedge") else 0,
                 wedges_read=int(self.wedge_read[:-1].sum())
                 if self.sampler == "wedge" else 0)
        return c


class WoodcockResult(NamedTuple):
    t: torch.Tensor           # (L,) f32: min(t, t1) at loop exit
    albedo: torch.Tensor      # (L, 3) f32
    extinction: torch.Tensor  # (L,) f32
    rng: torch.Tensor         # (L,) i64 holding the u32 LCG state
    steps: torch.Tensor       # (L,) i32 loop iterations of the lane


def woodcock_track(sample_fn: Callable, classify_fn: Callable,
                   org, direction, t0, t1, majorant, rng, unit_distance,
                   active=None, max_iters: int = MAX_ITERS,
                   work: Work | None = None, *,
                   shell_fn: Callable) -> WoodcockResult:
    """Track the ray segments [t0, t1] of L lanes against a constant
    majorant.

    sample_fn(pos (M, 3)) -> (hit (M,) bool, value (M,) f32);
    classify_fn(value (M,)) -> (M, 4) RGBA.  org (3,) or (L, 3),
    direction (L, 3), t0/t1 (L,), majorant a float or (L,) tensor, rng
    (L,) i64, unit_distance a () tensor; lanes with active False (rays
    that missed the volume) or majorant <= 0 skip the loop.  `work`, if
    given, counts the run's events.

    shell_fn(pos (M, 3)) -> (M,) bool is the sampler's exact shell test
    (`make_shell_fn`: a point that fails it hits nothing).  A lock-step
    iteration first takes up to SKIP_DRAWS draws whose points fail it --
    each one whole iteration of the per-lane loop: a draw, no acceptance
    draw -- before the one draw it samples, so a lane beside the shell
    needs a ninth of the iterations, each far cheaper than the sampler.
    The lanes' draws, steps and results are unchanged."""
    L = direction.shape[0]
    dev = direction.device
    majorant = torch.as_tensor(majorant, dtype=torch.float32,
                               device=dev).expand(L)
    out = dict(t=t0.clone(), rng=rng.clone(),
               albedo=torch.zeros(L, 3, dtype=torch.float32, device=dev),
               ext=torch.zeros(L, dtype=torch.float32, device=dev),
               steps=torch.zeros(L, dtype=torch.int32, device=dev))
    live = majorant > 0.0
    if active is not None:
        live = live & active
    ids = torch.nonzero(live).squeeze(1)
    state = dict(org=org.expand(L, 3)[ids], d=direction[ids], t1=t1[ids],
                 maj=majorant[ids],
                 rate=(majorant / unit_distance)[ids],   # deviceCode.cu:165
                 **{k: v[ids] for k, v in out.items()})

    def step(S, live):
        rng0, t_last, steps = S["rng"], S["t"], S["steps"]
        skipping = live
        # SKIP_DRAWS passes that may skip a draw, then the sampled one
        for k in range(SKIP_DRAWS + 1):
            rng1, xi = lcg_next(rng0)
            t = t_last - torch.log(1.0 - xi) / S["rate"]
            pos = S["org"] + S["d"] * t[:, None]
            if k == SKIP_DRAWS:
                break
            # a miss before the segment end, with a step left after it
            skip = skipping & ~(t > S["t1"]) & ~shell_fn(pos) \
                & (steps + 2 <= max_iters)
            rng0 = torch.where(skip, rng1, rng0)
            t_last = torch.where(skip, t, t_last)
            steps = steps + skip.to(steps.dtype)
            if work is not None:
                for event in ("draw", "eval", "shell"):
                    work.add(event, skip)
            skipping = skip
        beyond = t > S["t1"]
        hit, value = sample_fn(pos)
        if work is not None:
            work.add("draw", live)
            work.sample(pos, live & ~beyond)
        rgba = classify_fn(value)
        rng2, u = lcg_next(rng1)
        sampled = ~beyond & hit              # the acceptance draw only here
        accept = sampled & (rgba[:, 3] >= u * S["maj"])
        steps = steps + 1
        return dict(rng=torch.where(sampled, rng2, rng1), t=t,
                    albedo=torch.where(accept[:, None], rgba[:, :3],
                                       S["albedo"]),
                    ext=torch.where(accept, rgba[:, 3], S["ext"]),
                    steps=steps), \
            beyond | accept | (steps >= max_iters)

    lockstep(state, ids, step, out, max_iters)
    return WoodcockResult(torch.minimum(out["t"], t1), out["albedo"],
                          out["ext"], out["rng"], out["steps"])
