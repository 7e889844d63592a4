"""Where the Fletcher-Munson kernel K3's time goes, and its launch shapes.

    python3 tools/fm_norm_profile.py [--against DIR ...]

At base's p (1, 513, 626) and lv60's (1, 513, 1251), both in
``torch.stft``'s layout, it prints one JSON line per shape and checkout:

  * breakdown — for ``fm_weighted_power_sum`` as a caller sees it: the
    host's time to issue one call (µs, 1000 calls on the host clock, no
    synchronisation), the call time (ms, CUDA events around 100 calls back
    to back), the device time alone (ms, events around replays of a CUDA
    graph that captured 100 calls), and the device operations of one call
    with their durations (``torch.profiler``). ``--against`` runs the same
    measurement in other checkouts of the repository, each in its own
    process, in the order other, this, this, other: to compare a parent
    commit's K3 on the same card.
  * variants — K3 takes its grid cap and block size as arguments, so the
    built library runs every launch shape: blocks per SM (½, 1, 2, 4) ×
    threads per block (256, 512, 1024). Beside them run sources with a few
    literal substitutions, built with nvcc into ``build/paa_tpu_torch/``
    at the built launch shape: another form of the cross-block sum, and
    diagnostic cuts (``cut_*``: a part of the kernel left out, so the sum
    is wrong and not checked) that show what each part costs. Every
    variant that keeps the function is held against the plain version
    (1e-5); all are timed as device ms (the CUDA graph), three rounds in
    alternating order, beside K3 on one frame (its fixed cost) and a
    one-element PyTorch add (the floor of one kernel in a graph).

Every line carries the card's name and power limit. Needs one CUDA device.
``chip_smoke.py`` takes its device timer (``graph_ms``, for K3 and the
attention checks), K3's profiler names (``device_ops``) and its count of
K3's device operations (``graph_nodes``) from here.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = {"base": 160_000, "lv60": 320_000}
BLOCKS_PER_SM = (0.5, 1, 2, 4)
THREADS = (256, 512, 1024)
TICKET = """    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> ticket(*a.ticket);
    last = ticket.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
    if (last) ticket.store(0u, cuda::memory_order_relaxed);  // for the next call
"""
# name: [(text in csrc/fm_norm.cu, its replacement)]
SOURCE_VARIANTS = {
    # the ticket taken between two full fences, wrapping to 0 by itself
    "ticket_fences": [(TICKET, """    __threadfence();
    last = atomicInc(a.ticket, gridDim.x - 1) == gridDim.x - 1;
    if (last) __threadfence();
""")],
    # each block stores its partial, and no block sums them
    "cut_cross_block_sum": [(TICKET, ""), ("  __syncwarp();\n", "  return;\n")],
    "cut_table_staging": [("  stage_tables(a, smem);\n", "")],
    # no cell is loaded or weighted
    "cut_cells": [("const unsigned int pairs = a.dense ? (a.n - a.head) / 2 : 0;",
                   "const unsigned int pairs = 0;")],
}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def graph_ms(fn, calls=100, replays=5, stream=None) -> float:
    """Device ms of one ``fn`` call: a CUDA graph of ``calls`` calls, replayed.
    With ``stream`` it warms up and captures there: an autograd backward
    must be captured on the stream its forward ran on."""
    fn()
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


# CUgraphNodeType (cuda.h); the first three are work the device runs
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event",
              "event_record", "ext_semas_signal", "ext_semas_wait", "mem_alloc", "mem_free",
              "batch_mem_op", "conditional")
DEVICE_WORK = NODE_TYPES[:3]


def graph_nodes(fn) -> list[str]:
    """The type of each node of a CUDA graph that captured one call of
    ``fn``, read with the driver's ``cuGraphGetNodes``: the device
    operations of the call, counted without the profiler."""
    import ctypes

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    driver = ctypes.CDLL("libcuda.so.1")
    driver.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_size_t)]
    driver.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)

    def checked(rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{what} returned CUresult {rc}")

    checked(driver.cuGraphGetNodes(handle, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    checked(driver.cuGraphGetNodes(handle, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    kinds = []
    kind = ctypes.c_int()
    for node in nodes[:count.value]:
        checked(driver.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        kinds.append(NODE_TYPES[kind.value] if kind.value < len(NODE_TYPES) else str(kind.value))
    graph.reset()
    return kinds


def events_ms(fn, calls=100) -> float:
    """Call ms of ``fn``: CUDA events around ``calls`` calls back to back."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def host_us(fn, calls=1000) -> float:
    """Host µs to issue one call of ``fn``, no synchronisation inside."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * seconds / calls


def device_ops(fn, tries=3) -> list[list]:
    """[name, device µs] of each device operation (kernel, copy, fill) that
    one call of ``fn`` runs, from ``torch.profiler``. A trace that holds no
    device operation at all is taken again: on the H100 the profiler now and
    then returns one empty."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [[e.name, e.time_range.elapsed_us()] for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if ops:
            break
    return ops


def inputs(dev):
    """(tables, {shape name: p's STFT}) from seed 0, as the main paths make them."""
    from paa_tpu_torch.config import AttackConfig
    from paa_tpu_torch.ops import dsp, psycho

    cfg = AttackConfig(norm_type="fletcher_munson")
    g = torch.Generator(device=dev).manual_seed(0)
    specs = {name: dsp.stft(torch.randn((1, n), generator=g, device=dev) * 0.01, cfg.n_fft,
                            cfg.hop_length, cfg.win_length) for name, n in SAMPLES.items()}
    return psycho.build_tables(cfg, dev), specs


def breakdown(tree: str) -> None:
    from paa_tpu_torch.ops.kernels import fm_norm

    dev = torch.device("cuda")
    tables, specs = inputs(dev)
    for name, spec in specs.items():
        call = lambda: fm_norm.fm_weighted_power_sum(spec, tables)
        print(json.dumps({"part": "breakdown", "tree": tree, "case": name,
                          "shape": list(spec.shape), "strides": list(spec.stride()),
                          "host_us": host_us(call), "ms": events_ms(call),
                          "device_ms": graph_ms(call), "device_ops": device_ops(call),
                          "card": card()}), flush=True)


def build_variants() -> dict:
    """{name: loaded library} of the source variants, one nvcc each, in parallel."""
    import ctypes

    from paa_tpu_torch.ops.kernels import _lib

    procs = {}
    for name, subs in SOURCE_VARIANTS.items():
        text = (_lib.CSRC / "fm_norm.cu").read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in fm_norm.cu")
            text = text.replace(old, new)
        src = _lib.BUILD_DIR / f"variant_fm_{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", str(src), "-o",
             str(src.with_suffix(".so"))], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        lib = ctypes.CDLL(str(_lib.BUILD_DIR / f"variant_fm_{name}.so"))
        lib.paa_fm_power_sum.argtypes = list(_lib._SIGNATURES["paa_fm_power_sum"])
        lib.paa_fm_power_sum.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(spec, tables, blocks: int, threads: int, lib=None):
    """One K3 launch of the built library, or of ``lib``, at the given grid
    cap and block size."""
    from paa_tpu_torch.ops.kernels import _lib

    dev = spec.device
    lib = lib or _lib.library()
    partials = torch.zeros(blocks, dtype=torch.float32, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    F, T = spec.shape[-2:]

    def call():
        out = torch.empty((), dtype=torch.float32, device=dev)
        _lib.check(lib.paa_fm_power_sum(
            spec.data_ptr(), tables.fm_table.data_ptr(), tables.fm_in_domain.data_ptr(),
            partials.data_ptr(), ticket.data_ptr(), out.data_ptr(), spec.shape[0], F, T,
            *spec.stride(), blocks, threads, torch.cuda.current_stream(dev).cuda_stream),
            "fm_norm variant")
        return out
    return call


def variants() -> None:
    from paa_tpu_torch.ops.kernels import fm_norm

    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    tables, specs = inputs(dev)
    libs = build_variants()
    one = torch.zeros(1, device=dev)
    for name, spec in specs.items():
        want = float(fm_norm.fm_weighted_power_sum_plain(spec, tables))
        grid = {f"{b}x{t}": launcher(spec, tables, max(1, int(b * n_sm)), t)
                for b in BLOCKS_PER_SM for t in THREADS}
        grid.update({k: launcher(spec, tables, n_sm, fm_norm.THREADS, lib)
                     for k, lib in libs.items()})
        errs = {k: abs(float(fn()) - want) / want for k, fn in grid.items()
                if not k.startswith("cut_")}
        bad = {k: v for k, v in errs.items() if not v <= 1e-5}
        if bad:
            raise RuntimeError(f"variants out of tolerance at {name}: {bad}")
        frame = spec[..., :1]
        timed = {**grid, "one_frame_built": lambda: fm_norm.fm_weighted_power_sum(frame, tables),
                 "one_element_add": lambda: one.add_(1.0)}
        names = list(timed)
        rounds = [{k: graph_ms(timed[k]) for k in (names if r % 2 == 0 else names[::-1])}
                  for r in range(3)]
        print(json.dumps({"part": "variants", "case": name, "shape": list(spec.shape),
                          "sms": n_sm, "built": f"1x{fm_norm.THREADS}",
                          "device_ms": {k: [r[k] for r in rounds] for k in names},
                          "rel_err": errs, "card": card()}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", nargs="*", default=[], metavar="DIR",
                    help="other checkouts whose K3 is measured the same way")
    ap.add_argument("--breakdown-of", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fm_norm_profile.py: no CUDA device", file=sys.stderr)
        return 1
    if args.breakdown_of:  # one checkout's breakdown, in its own process
        sys.path.insert(0, args.breakdown_of)
        breakdown(args.breakdown_of)
        return 0
    order = [d for other in args.against for d in (other, REPO, REPO, other)] or [REPO]
    for tree in order:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--breakdown-of",
                        os.path.abspath(tree)], check=True)
    sys.path.insert(0, REPO)
    variants()
    return 0


if __name__ == "__main__":
    sys.exit(main())
