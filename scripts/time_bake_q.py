#!/usr/bin/env python
"""K5c-q, the quantized tier's TF-edit bake, on the card at R2B9: the
lookup (into a new table and in place), the edits that run it, their
bounds and output hashes, for one tree of the repository or two or more
in turns; with --variants, probe builds of other designs, the in-place
patch among them.

    python scripts/time_bake_q.py                  # this tree
    python scripts/time_bake_q.py --turns A B      # trees A, B, B, A
    python scripts/time_bake_q.py --variants       # + probe builds

Each tree runs in a process of its own that imports that tree's
icon_rt_tpu_torch (its kernels build into the tree's own _build/).  On
chip_smoke.py's R2B9 scene (`r2b9_scene`: build_q_scene(11, 16), 83,886,080
columns, value_q (N, 16) u8) and main r2b9q's 1920x1080 closeup:

  1. the kernels, CUDA events around REPS wrapper calls after a warm one
     (`ms`: the kernel with the wrapper's host work) and one call under
     chip_smoke.py's `profile_window` (`kernel_ms`: the device time of the
     kernels whose name holds the bake's, None where the profiler lost
     them): the lookup into a new table and, where the tree has it, into
     a given one (out=); and two edits into a new table, each in the form
     the tree's `bake_alpha_q` runs it (a tree with `bake_patch`: that
     patch of the old table; else the lookup of the edited table, equal
     by the invariant alpha_q == alpha_tab[value_q]): "stroke", the levels
     chip_smoke.py's `stroke_edit(tf, 0.5)` changes (-1 padded to 32), and
     "spread", every 8th level (32, hitting nearly every 16-layer row);
     each beside its bound (bytes at 3.35 TB/s: the lookup 2n) and the
     sha256 of its output (trees that compute the same bits print the
     same hashes);
  2. the TF edit end to end, as main r2b9q times it (from the edit to the
     next samples=1 frame's fb on the host, median of EDITS) with the
     bake's own host wall and the edit's peak device memory above what
     was held: the stroke from one base (bench.py's `_measure_row_q`), and
     a chain of stroke edits each from the table before it, donated where
     the tree's `bake_alpha_q` takes `donate` (the app's get_q);
  3. with --variants (this tree only): probe builds of csrc/bake_q.cu,
     written into the tree's _build/ and not kept, their outputs' hashes
     held to the built kernel's: (a) the lookup (`LOOKUP_VARIANTS`, timed
     as in 1): the table read through L1 (`p.tab`) instead of shared
     memory, or from 32 copies in shared memory, lane l's in bank l (no
     bank conflict); streaming hints (__ldcs, __stcs) on the loads and
     stores; 2 or 4 vectors a thread instead of one; 4 vectors a thread
     over a grid sized to the SMs (their resident blocks), striding over
     the chunks; (b) an in-place patch (`PATCH_SOURCE`: a 256-entry level
     map a block, a 16-byte vector with no changed level writes nothing,
     a hit vector is read, merged and written back; and the same with one
     store a changed byte), at both edits in place (on a scratch copy;
     bound n + the entries whose level changes, counted from value_q's
     level histogram) and as a copy then the patch (bound 3n), its output
     held to the lookup of the edited table; the patch of K levels spread
     over the 256 (K = 1 ... 256), and of K contiguous levels from the
     stroke's first (K = 1 ... 16), against the in-place lookup; the
     bank-conflict ways of the shared-memory tables on this data (the
     mean and largest, over 65,536 sampled warp loads of one byte position
     of 32 neighbouring 16-byte vectors, of the distinct 4-byte words that
     one bank serves: the 256-byte lookup table and the 512-byte u16 level
     map).

Each process prints a `time_bake_q {json}` line; --turns prints a summary
of each tree's runs after them.  Needs a CUDA card: without one it exits
non-zero.
"""
import argparse
import inspect
import os
import re
import sys
import time

import kernel_timing as kt
from kernel_timing import events_ms

REPS = 10
EDITS = 5
W, H = 1920, 1080
CROSSOVER = (1, 2, 3, 4, 6, 8, 12, 16, 32, 64, 128, 256)
BAND = (1, 2, 3, 4, 6, 8, 16)     # contiguous levels from the stroke's first
WHO = "time_bake_q"


def lookup_body(unroll, sm_grid=False):
    """The lookup kernel's body with `unroll` vectors a thread, each block
    a chunk of unroll x kThreads vectors; over a grid of every chunk, or
    (sm_grid) striding over the chunks.  The tail is the shipped one."""
    loop = ("for (long long base = blockIdx.x * chunk; base < nv;\n"
            "       base += gridDim.x * chunk) {" if sm_grid else
            "{\n    const long long base = blockIdx.x * chunk;")
    return f"""{{
  __shared__ uint8_t tab[256];
  tab[threadIdx.x] = p.tab[threadIdx.x];
  __syncthreads();
  const long long nv = p.n >> 4;
  const long long chunk = {unroll}ll * kThreads;
  {loop}
    uint4 v[{unroll}];
#pragma unroll
    for (int k = 0; k < {unroll}; ++k) {{
      const long long i = base + k * kThreads + threadIdx.x;
      v[k] = i < nv ? reinterpret_cast<const uint4*>(p.vq)[i]
                    : make_uint4(0, 0, 0, 0);
    }}
#pragma unroll
    for (int k = 0; k < {unroll}; ++k) {{
      const long long i = base + k * kThreads + threadIdx.x;
      if (i < nv)
        reinterpret_cast<uint4*>(p.out)[i] =
            make_uint4(lookup4(tab, v[k].x), lookup4(tab, v[k].y),
                       lookup4(tab, v[k].z), lookup4(tab, v[k].w));
    }}
  }}
  const long long j = (nv << 4) + (long long)blockIdx.x * kThreads +
                      threadIdx.x;
  if (j < p.n) p.out[j] = tab[p.vq[j]];
}}"""


def lookup_launch(unroll, sm_grid):
    """The lookup's launch: a block a chunk of unroll x kThreads vectors,
    at most the SMs' resident blocks when sm_grid."""
    most = """
  static int most = 0;
  if (most == 0) {
    int dev, sms, per_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, reinterpret_cast<const void*>(bake_lookup_kernel),
          kThreads, 0);
    if (err != cudaSuccess) return err;
    most = sms * (per_sm > 0 ? per_sm : 1);
  }
  if (blocks > most) blocks = most;""" if sm_grid else ""
    return f"""{{
  const long long chunk = {unroll}ll * kThreads;
  long long blocks = ((p->n >> 4) + chunk - 1) / chunk;
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;{most}
  void* args[] = {{const_cast<BakeParams*>(p)}};
  cudaLaunchKernel(reinterpret_cast<const void*>(bake_lookup_kernel),
                   dim3(blocks < 1 ? 1 : unsigned(blocks)), dim3(kThreads),
                   args, 0, static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}}"""


def unrolled(unroll, sm_grid=False):
    return [{"bake_lookup_kernel(const BakeParams p)":
             lookup_body(unroll, sm_grid),
             'extern "C" int bake_lookup_launch': lookup_launch(unroll,
                                                                 sm_grid)}]


#: probe edits of csrc/bake_q.cu's lookup: name -> its edits (`probe_edit`)
LOOKUP_VARIANTS = {
    "lookup_l1": [(r"lookup4\(tab, ", "lookup4(p.tab, "),
                  (r"p\.out\[j\] = tab\[p\.vq\[j\]\];",
                   "p.out[j] = p.tab[p.vq[j]];")],
    "lookup_lane_copies": [
        (r"(__global__ void __launch_bounds__\(kThreads\)\n"
         r"bake_lookup_kernel)",
         "__device__ __forceinline__ uint32_t lookup4_lane(const uint8_t* t,\n"
         "                                                 uint32_t w) {\n"
         "  uint32_t r = 0;\n"
         "#pragma unroll\n"
         "  for (int b = 0; b < 4; ++b) {\n"
         "    const uint32_t v = (w >> (8 * b)) & 0xffu;\n"
         "    r |= uint32_t(t[(v >> 2) * 128 + (v & 3)]) << (8 * b);\n"
         "  }\n"
         "  return r;\n"
         "}\n\n\\1"),
        (r"(bake_lookup_kernel\(const BakeParams p\) \{\n"
         r"  __shared__ uint8_t tab\[256\];\n"
         r"  tab\[threadIdx\.x\] = p\.tab\[threadIdx\.x\];\n"
         r"  __syncthreads\(\);\n)",
         "\\1  __shared__ uint32_t lanes[64 * 32];\n"
         "  for (int i = threadIdx.x; i < 64 * 32; i += kThreads)\n"
         "    lanes[i] = reinterpret_cast<const uint32_t*>(tab)[i >> 5];\n"
         "  __syncthreads();\n"
         "  const uint8_t* mine = reinterpret_cast<const uint8_t*>(lanes) +\n"
         "                        4 * (threadIdx.x & 31);\n"),
        (r"lookup4\(tab, ", "lookup4_lane(mine, ")],
    "cache_hints": [
        (r"reinterpret_cast<const uint4\*>\(p\.vq\)\[i\]",
         "__ldcs(reinterpret_cast<const uint4*>(p.vq) + i)"),
        (r"reinterpret_cast<uint4\*>\(p\.out\)\[i\] =\n(\s+)"
         r"(make_uint4\([^;]*\));",
         "__stcs(reinterpret_cast<uint4*>(p.out) + i,\n\\1\\2);")],
    "unroll_2": unrolled(2), "unroll_4": unrolled(4),
    "sm_grid_unroll_4": unrolled(4, sm_grid=True)}

#: the in-place patch, appended to csrc/bake_q.cu by the patch probes:
#: aq[vq == lev[j]] = new[j] through a 256-entry level map a block
PATCH_SOURCE = r"""
struct PatchParams {
  const uint8_t* vq;
  const int32_t* lev;   // (n_lev,) changed levels, -1 padded
  const uint8_t* newv;  // (n_lev,) their new values
  uint8_t* out;         // (n,) patched in place
  long long n;
  int n_lev;
};

namespace {

constexpr uint32_t kHit = 0x100;  // a level map entry that writes its byte

// The map's new bytes of the levels packed in w, and in `hit` 0xff in each
// byte whose level changed.
__device__ __forceinline__ uint32_t patch4(const uint16_t* m, uint32_t w,
                                           uint32_t& hit) {
  uint32_t val = 0;
  hit = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t e = m[(w >> (8 * b)) & 0xffu];
    val |= (e & 0xffu) << (8 * b);
    hit |= (e >> 8) * (0xffu << (8 * b));
  }
  return val;
}

// Write the bytes of `val` that `hit` marks into the 16 bytes at o: one
// 16-byte store, after a read of o unless every byte changed.
__device__ __forceinline__ void store_hits(uint8_t* o, const uint4& val,
                                           const uint4& hit) {
  uint4* v = reinterpret_cast<uint4*>(o);
  uint4 a = (hit.x & hit.y & hit.z & hit.w) == 0xffffffffu ? val : *v;
  a.x = (a.x & ~hit.x) | (val.x & hit.x);
  a.y = (a.y & ~hit.y) | (val.y & hit.y);
  a.z = (a.z & ~hit.z) | (val.z & hit.z);
  a.w = (a.w & ~hit.w) | (val.w & hit.w);
  __stcs(v, a);
}

__global__ void __launch_bounds__(kThreads)
bake_patch_kernel(const PatchParams p) {
  __shared__ uint16_t map[256];
  map[threadIdx.x] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < p.n_lev; j += kThreads) {
    const int l = p.lev[j];
    if (l >= 0 && l < 256) map[l] = uint16_t(kHit | p.newv[j]);
  }
  __syncthreads();
  const long long nv = p.n >> 4;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < nv) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p.vq) + i);
    uint4 hit, val;
    val.x = patch4(map, v.x, hit.x);
    val.y = patch4(map, v.y, hit.y);
    val.z = patch4(map, v.z, hit.z);
    val.w = patch4(map, v.w, hit.w);
    if (hit.x | hit.y | hit.z | hit.w) store_hits(p.out + 16 * i, val, hit);
  }
  const long long j = (nv << 4) + i;
  if (j < p.n) {
    const uint32_t e = map[p.vq[j]];
    if (e & kHit) p.out[j] = uint8_t(e);
  }
}

}  // namespace

extern "C" int bake_patch_launch(const PatchParams* p, void* stream) {
  const long long blocks = ((p->n >> 4) + kThreads - 1) / kThreads;
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  void* args[] = {const_cast<PatchParams*>(p)};
  cudaLaunchKernel(reinterpret_cast<const void*>(bake_patch_kernel),
                   dim3(blocks < 1 ? 1 : unsigned(blocks)), dim3(kThreads),
                   args, 0, static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}
"""
BYTE_STORES = {"__device__ __forceinline__ void store_hits": """{
  if ((hit.x & hit.y & hit.z & hit.w) == 0xffffffffu) {
    __stcs(reinterpret_cast<uint4*>(o), val);
    return;
  }
  const uint32_t h[4] = {hit.x, hit.y, hit.z, hit.w};
  const uint32_t w[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (h[k >> 2] >> (8 * (k & 3)) & 1u)
      o[k] = uint8_t(w[k >> 2] >> (8 * (k & 3)));
}"""}
PATCH_VARIANTS = {"patch": [], "patch_byte_stores": [BYTE_STORES]}


def probe_edit(changes, append=""):
    """edit(file name, text) -> text for kt.probe_build: bake_q.cu with
    `append` added at its end, then each of `changes` in turn, a (pattern,
    replacement) regular expression that must match or a {function head:
    its new body} dict."""
    def edit(fname, text):
        if fname != "bake_q.cu":
            return text
        text += append
        for change in changes:
            if isinstance(change, dict):
                for head, body in change.items():
                    i, j = kt.function_body(text, head, WHO)
                    text = text[:i] + body + text[j + 1:]
                continue
            text, k = re.subn(change[0], change[1], text)
            if not k:
                raise SystemExit(f"{WHO}: {change[0]!r} matches nothing")
        return text
    return edit


def patch_probe(name):
    """(patch_(vq, aq, lev, new) -> aq, ptxas log) of the probe build of
    PATCH_VARIANTS[name]: the in-place patch on the card."""
    import ctypes
    import torch
    lib, log = kt.probe_build("bake_q", probe_edit(PATCH_VARIANTS[name],
                                                   PATCH_SOURCE), WHO)

    class PatchParams(ctypes.Structure):
        _fields_ = [(f, ctypes.c_void_p) for f in ("vq", "lev", "newv",
                                                   "out")] + [
            ("n", ctypes.c_longlong), ("n_lev", ctypes.c_int)]
    fn = lib.bake_patch_launch
    fn.argtypes = [ctypes.POINTER(PatchParams), ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def patch_(vq, aq, lev, new):
        p = PatchParams(vq=vq.data_ptr(), lev=lev.data_ptr(),
                        newv=new.data_ptr(), out=aq.data_ptr(), n=vq.numel(),
                        n_lev=lev.numel())
        err = fn(ctypes.byref(p), torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{WHO}: {name}: launch error {err}")
        return aq
    return patch_, log


def level_histogram(vq):
    """(256,) int64: how many entries of the u8 table hold each level
    (bincount by chunks of 2**28 entries)."""
    import torch
    flat = vq.view(-1)
    hist = torch.zeros(256, dtype=torch.int64, device=vq.device)
    for i in range(0, flat.numel(), 1 << 28):
        hist += torch.bincount(flat[i:i + (1 << 28)], minlength=256)
    return hist


def kernel_ms(cs, call, kernel, tag):
    """Device ms of the events whose name holds `kernel` in one profiled
    `call`, or None where the profiler lost them."""
    try:
        prof = kt.profiled(cs, call, (kernel,), tag)
    except AssertionError as e:
        print(f"{tag}: {e}", flush=True)
        return None
    return sum(v for k, v in prof["by_name"].items() if kernel in k)


def conflict_ways(vq, entry_bytes, groups=1 << 16):
    """(mean, largest) over `groups` sampled warp loads of the distinct
    4-byte words one shared-memory bank (of 32) serves when 32 lanes read
    the entries of byte k of 32 neighbouring 16-byte vectors of vq, in a
    256-entry table of `entry_bytes`-byte entries."""
    import torch
    flat = vq.view(-1)
    nw = flat.numel() // 512
    pick = torch.linspace(0, nw - 1, min(groups, nw),
                          device=vq.device).long()
    v = flat[:nw * 512].view(nw, 32, 16)[pick].long().transpose(1, 2)
    words = 256 * entry_bytes // 4
    hot = torch.zeros(v.shape[0], 16, words, dtype=torch.bool,
                      device=vq.device)
    hot.scatter_(2, v * entry_bytes // 4, True)
    ways = hot.view(v.shape[0], 16, words // 32, 32).sum(2).amax(-1)
    return float(ways.float().mean()), int(ways.max())


def timed(cs, out, key, call, kernel, bnd, label):
    """out[key]: events ms, profiled kernel ms, bound and output hash of
    `call`."""
    res = call()
    out[key] = {"ms": events_ms(call, reps=REPS),
                "kernel_ms": kernel_ms(cs, call, kernel, f"{WHO} {label} {key}"),
                "bound_ms": bnd, "hash": kt.digest(res)}
    out[key]["bound_share"] = bnd / out[key]["ms"]


def bake_times(cs, qcells, q, tab, edits, label):
    """Step 1's timings, hashes and bounds of the tree's K5c-q wrappers;
    edits {name: (lev, new, the edited table)}."""
    import torch
    vq, n = q.value_q, q.value_q.numel()
    b2 = cs.bound(2 * n, 0)[0]
    out = {}
    timed(cs, out, "lookup", lambda: qcells.bake_lookup(vq, tab),
          "bake_lookup", b2, label)
    scratch = q.alpha_q.clone()
    if "out" in inspect.signature(qcells.bake_lookup).parameters:
        timed(cs, out, "lookup_out",
              lambda: qcells.bake_lookup(vq, tab, out=scratch),
              "bake_lookup", b2, label)
    for name, (lev, new, edited) in edits.items():
        if hasattr(qcells, "bake_patch"):
            timed(cs, out, f"edit_{name}", lambda: qcells.bake_patch(
                vq, q.alpha_q, lev, new), "bake_patch", b2, label)
        else:
            timed(cs, out, f"edit_{name}", lambda: qcells.bake_lookup(
                vq, edited), "bake_lookup", b2, label)
    del scratch
    torch.cuda.empty_cache()
    return out


def patch_times(cs, qcells, q, tab, edits, hist, first):
    """Step 3b: {variant: timings} of the in-place patch probes, the
    crossover against the in-place lookup and the conflict ways."""
    import torch
    vq, n = q.value_q, q.value_q.numel()
    dev = vq.device
    b = lambda nbytes: cs.bound(nbytes, 0)[0]
    out = {}
    for name in PATCH_VARIANTS:
        patch_, log = patch_probe(name)
        got = {"ptxas": cs.ptxas_lines(log)}
        for e, (lev, new, edited) in edits.items():
            scratch = q.alpha_q.clone()
            changed = int(hist[lev[lev >= 0].long()].sum())
            want = qcells.bake_lookup(vq, edited)
            same = torch.equal(patch_(vq, q.alpha_q.clone(), lev, new), want)
            del want
            timed(cs, got, f"{e}_inplace",
                  lambda: patch_(vq, scratch, lev, new), "bake_patch",
                  b(n + changed), name)
            timed(cs, got, f"{e}_copy",
                  lambda: patch_(vq, q.alpha_q.clone(), lev, new),
                  "bake_patch", b(3 * n), name)
            got[f"{e}_inplace"].update(changed=changed, equals_lookup=same)
            del scratch
            torch.cuda.empty_cache()
        if name == "patch":
            scratch = q.alpha_q.clone()
            cross = {"lookup_out": events_ms(lambda: qcells.bake_lookup(
                vq, tab, out=scratch), reps=REPS)}
            runs = [("spread", k, torch.arange(k, device=dev) * 256 // k)
                    for k in CROSSOVER]
            runs += [("band", k, first + torch.arange(k, device=dev))
                     for k in BAND]
            for kind, k, lv in runs:
                lv = lv.to(torch.int32)
                nw = 255 - tab[lv.long()]
                cross[f"{kind}_{k}"] = {"ms": events_ms(lambda: patch_(
                    vq, scratch, lv, nw), reps=REPS),
                    "changed": int(hist[lv.long()].sum())}
            got["crossover"] = cross
            del scratch
        torch.cuda.empty_cache()
        out[name] = got
    out["conflict_ways"] = {"lookup_table": conflict_ways(vq, 1),
                            "level_map": conflict_ways(vq, 2)}
    return out


def edit_times(cs, qcells, scene, frame, donating):
    """Step 2: (one-base, chain) {"s", "bake_s", "peak_gib"} medians."""
    import numpy as np
    import torch
    from icon_rt_tpu_torch.models.shells import update_band_majorants
    from icon_rt_tpu_torch.ops.fastq import render_frame_fast_q
    from icon_rt_tpu_torch.ops.render import alloc_frame
    q, loc, bands, tf, fm = scene
    lp, perm, n_active = frame
    dev = q.value_q.device
    kw = {"donate": True} if donating else {}

    def edit(base, tf2, **k):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        q2 = qcells.bake_alpha_q(base, tf2, **k)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bands2 = update_band_majorants(bands, tf2.values, tf2.value_range)
        a2, f2 = alloc_frame(W, H, device=dev)
        render_frame_fast_q(q2, loc, bands2, tf2, lp, a2, f2, width=W,
                            height=H, pixel_perm=perm, n_active=n_active,
                            samples=1, finemap=fm)
        np.asarray(f2.cpu())
        t2 = time.perf_counter()
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        return q2, (t2 - t0, t1 - t0, peak)

    def median(runs):
        return {k: float(np.median([r[i] for r in runs]))
                for i, k in enumerate(("s", "bake_s", "peak_gib"))}

    edit(q, cs.stroke_edit(tf, 0.7))
    base = [edit(q, cs.stroke_edit(tf, 0.5))[1] for _ in range(EDITS)]
    qd = q._replace(alpha_q=q.alpha_q.clone())
    chain = []
    for k in range(2 * EDITS + 1):
        qd, t = edit(qd, cs.stroke_edit(tf, 0.7 if k % 2 else 0.5), **kw)
        chain.append(t)
    good = torch.equal(qd.alpha_q, qcells.bake_lookup(
        q.value_q, torch.from_numpy(qd.alpha_tab).to(dev)))
    h = kt.digest(qd.alpha_q)
    del qd
    torch.cuda.empty_cache()
    return median(base), dict(median(chain[1:]), hash=h,
                              equals_lookup=good)


def measure(root, variants):
    sys.path.insert(0, os.path.abspath(root))
    import json
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit(f"{WHO}: no CUDA card")
    from icon_rt_tpu_torch.models import qcells
    if not qcells.__file__.startswith(os.path.abspath(root) + os.sep):
        raise SystemExit(f"{WHO}: imported {qcells.__file__}, not the "
                         f"package under {root}")
    cs = kt.chip_smoke()
    dev = torch.device("cuda", 0)
    out = {"root": os.path.abspath(root), "card": kt.card()}
    q, loc, _, bands, tf, stats, fm, _, _ = cs.r2b9_scene(dev, WHO)
    frame = cs.r2b9_frame(stats, W, H, dev)
    out["shape"] = list(q.value_q.shape)
    tab = torch.from_numpy(q.alpha_tab).to(dev)
    tab_s = qcells.bake_alpha_q(q, cs.stroke_edit(tf, 0.5)).alpha_tab
    torch.cuda.empty_cache()
    changed = np.nonzero(tab_s != q.alpha_tab)[0].astype(np.int32)
    lev = np.full(max(32, changed.size), -1, np.int32)
    lev[:changed.size] = changed
    spread = torch.arange(0, 256, 8, dtype=torch.int32, device=dev)
    tab_p = tab.clone()
    tab_p[spread.long()] = 255 - tab[spread.long()]
    edits = {"stroke": (torch.from_numpy(lev).to(dev), torch.from_numpy(
                 tab_s[np.maximum(lev, 0)]).to(dev),
                 torch.from_numpy(tab_s).to(dev)),
             "spread": (spread, tab_p[spread.long()], tab_p)}
    out["stroke_levels"] = changed.tolist()
    out.update(bake_times(cs, qcells, q, tab, edits, "built"))
    if hasattr(qcells, "bake_q_occupancy"):
        out["occupancy"] = qcells.bake_q_occupancy()

    donating = "donate" in inspect.signature(qcells.bake_alpha_q).parameters
    one_base, chain = edit_times(cs, qcells, (q, loc, bands, tf, fm), frame,
                                 donating)
    out["edit_one_base"] = one_base
    out["edit_chain"] = dict(chain, donated=donating)

    if variants:
        from icon_rt_tpu_torch.utils import cuda_build
        hist = level_histogram(q.value_q)
        first = int(changed[0]) if changed.size else 100
        out["patch_probes"] = patch_times(cs, qcells, q, tab, edits, hist,
                                          first)
        built = cuda_build._BUILT.pop("bake_q")
        out["variants"] = {}
        try:
            for name, changes in LOOKUP_VARIANTS.items():
                lib, log = kt.probe_build("bake_q", probe_edit(changes), WHO)
                cuda_build._BUILT["bake_q"] = {"lib": lib, "seconds": 0.0,
                                               "log": log}
                got = bake_times(cs, qcells, q, tab, edits, name)
                same = all(got[k]["hash"] == out[k]["hash"] for k in got)
                out["variants"][name] = dict(
                    {k: {"ms": v["ms"], "kernel_ms": v["kernel_ms"]}
                     for k, v in got.items()}, same_hashes=same,
                    ptxas=cs.ptxas_lines(log))
                cuda_build._BUILT.pop("bake_q")
        finally:
            cuda_build._BUILT["bake_q"] = built
    print(f"{WHO} " + json.dumps(out), flush=True)


def turns(trees):
    runs = kt.turns(__file__, WHO, trees, [])
    for root in trees:
        mine = runs[root]
        keys = [k for k in mine[0] if k.startswith(("lookup", "edit_"))
                and isinstance(mine[0][k], dict) and "ms" in mine[0][k]]
        for k in keys:
            print(f"{WHO} summary {root}: {k} ms "
                  f"{[round(r[k]['ms'], 4) for r in mine]}, kernel "
                  f"{[r[k]['kernel_ms'] for r in mine]}, bound "
                  f"{round(mine[0][k]['bound_ms'], 4)}, hash "
                  f"{[r[k]['hash'] for r in mine]}")
        for k in ("edit_one_base", "edit_chain"):
            print(f"{WHO} summary {root}: {k} {[r[k] for r in mine]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=kt.HERE,
                    help="the tree whose package to time")
    ap.add_argument("--turns", nargs="+", metavar="TREE",
                    help="time two or more trees in turns, forth and back "
                         "(A, B, B, A)")
    ap.add_argument("--variants", action="store_true",
                    help="also time probe builds of csrc/bake_q.cu")
    args = ap.parse_args()
    if args.turns:
        if len(args.turns) < 2:
            ap.error("--turns takes two or more trees")
        turns(args.turns)
    else:
        measure(args.root, args.variants)


if __name__ == "__main__":
    main()
