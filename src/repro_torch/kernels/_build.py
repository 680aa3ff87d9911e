"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` for Hopper (``sm_90a``) into a shared library, which
``ctypes`` loads.  Libraries land in ``repro_torch/_build/`` (listed in
``.gitignore``) under a name keyed on a hash of the source and flags, so
an edited source (or shared ``csrc/*.cuh`` header) rebuilds and an
unchanged one is reused.  :func:`build_all` starts one ``nvcc`` per stale
source, all at once; :func:`entry` returns one of a source's C entry
points with its argument types bound once, when the library loads.

No ``--use_fast_math``: the packed matmul's bit-exactness against its
plain version rests on IEEE division and round-half-even, and the
attention and SSD kernels use full-precision ``expf``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("ent_matmul", "int8_matmul", "flash_attention", "paged_attention",
           "ssd_scan")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# each source's extern "C" entry points and their argument types (all
# return an int: a cudaError_t, or for the *_smem functions a size)
ENTRY_POINTS = {
    "ent_matmul": {
        "ent_matmul_packed_fused_stream": [_P, _I, _P, _P, _P, _P, _I, _P, ctypes.c_longlong,
                                           _P] + [_I] * 7 + [_P],
        "ent_matmul_packed_fused_tc": [_P, _I, _P, _P, _P, _P, _I, _P, ctypes.c_longlong,
                                       _P] + [_I] * 6 + [_P],
        "ent_matmul_stream_smem": [_I, _I],
        "ent_matmul_tc_smem": [_I],
        "ent_matmul_packed_stream": [_P] * 5 + [_I, _P, ctypes.c_longlong, _P] + [_I] * 7
                                    + [_P],
        "ent_matmul_packed_tc": [_P] * 5 + [_I, _P, ctypes.c_longlong, _P] + [_I] * 6 + [_P],
        "ent_matmul_packed_stream_smem": [_I, _I],
        "ent_matmul_packed_tc_smem": [],
        "ent_matmul_planes_stream": [_P] * 5 + [_I, _P, ctypes.c_longlong, _P] + [_I] * 7
                                    + [_P],
        "ent_matmul_planes_tc": [_P] * 5 + [_I, _P, ctypes.c_longlong, _P] + [_I] * 6 + [_P],
        "ent_matmul_planes_stream_smem": [_I, _I],
        "ent_matmul_planes_tc_smem": []},
    "int8_matmul": {
        "int8_matmul_stream": [_P] * 5 + [_I, _P, ctypes.c_longlong, _P] + [_I] * 7 + [_P],
        "int8_matmul_tc": [_P] * 5 + [_I, _P, ctypes.c_longlong, _P] + [_I] * 6 + [_P],
        "int8_matmul_stream_smem": [_I, _I],
        "int8_matmul_tc_smem": []},
    "flash_attention": {
        "flash_attention_masked": [_P] * 6 + [_I] * 10 + [_F, _P],
        "flash_attention_fwd": [_P] * 5 + [_I] * 10 + [_F, _P],
        "flash_attention_bwd_dkdv": [_P] * 9 + [_I] * 10 + [_F, _P],
        "flash_attention_bwd_dq": [_P] * 8 + [_I] * 10 + [_F, _P],
        "flash_attention_tc_smem": [_I, _I]},
    "paged_attention": {
        "paged_attention": [_P] * 10 + [ctypes.c_longlong, _P] + [_I] * 11 + [_F, _I, _P],
        "paged_attention_smem": [_I] * 7,
        "ring_decode_attention": [_P] * 9 + [ctypes.c_longlong, _P] + [_I] * 11
                                 + [_F, _I, _P],
        "ring_decode_smem": [_I] * 6},
    "ssd_scan": {
        "ssd_fwd_states": [_P] * 6 + [_I] * 7 + [_P],
        "ssd_fwd_carry": [_P] * 2 + [_I] * 5 + [_P],
        "ssd_fwd_out": [_P] * 7 + [_I] * 8 + [_P],
        "ssd_prefill_states": [_P] * 6 + [_I] * 7 + [_P],
        "ssd_prefill_carry": [_P] * 4 + [_I] * 5 + [_P],
        "ssd_prefill_out": [_P] * 7 + [_I] * 7 + [_P],
        "ssd_bwd_own": [_P] * 6 + [_I] * 8 + [_P],
        "ssd_bwd_carry": [_P] * 2 + [_I] * 5 + [_P],
        "ssd_scan_bwd_chunk": [_P] * 13 + [_I] * 7 + [_P],
        "ssd_scan_smem": [_I]},
}

_entries: dict = {}      # (source, function) -> bound ctypes function
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "at first use on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> list[str]:
    """Compile every stale library among ``names`` in parallel; returns
    the names it built.  Raises with the compiler's output on failure."""
    nvcc = None
    procs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        nvcc = nvcc or _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return list(procs)


def entry(name: str, fname: str | None = None):
    """C entry point ``fname`` (default: the source's only one) of
    ``csrc/<name>.cu``, built and loaded on first use, with its ctypes
    signature bound."""
    if fname is None:
        (fname,) = ENTRY_POINTS[name]
    if (name, fname) not in _entries:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for f, argtypes in ENTRY_POINTS[name].items():
            fn = getattr(lib, f)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _entries[name, f] = fn
    return _entries[name, fname]


def load_all() -> None:
    """Build every stale library and load every entry point (a server
    does this before its first tick)."""
    build_all()
    for name, fns in ENTRY_POINTS.items():
        for fname in fns:
            entry(name, fname)


def stream_of(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as an int handle."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


_sms: dict = {}           # device -> SM count
_workspaces: dict = {}    # (device, CUDA stream[, kind]) -> (int32 words, int32 tickets)


def sm_count(dev) -> int:
    """The SM count of CUDA device ``dev`` (read once)."""
    if dev not in _sms:
        import torch
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _sms[dev]


def stream_workspace(key, words: int, tickets: int):
    """A split kernel's workspace for ``key`` = (device, CUDA stream[,
    kind]): int32 words for the blocks' partials and int32 ticket
    counters, allocated zeroed and grown when a call needs more.  Every
    call leaves the tickets zero for the next one; calls on one CUDA stream
    run in turn, and each CUDA stream has its own.  Kernels 1 and 6 share
    the (device, CUDA stream) one, whose split-K sums every call also leaves
    zero; the paged decode (kernels 3 and 3b, and its ring form) keeps its
    own under kind "paged", with its f32 partials in the words, which need
    no zeroing."""
    import torch
    ws, tk = _workspaces.get(key, (None, None))
    if ws is None or ws.numel() < words or tk.numel() < tickets:
        words = max(words, 0 if ws is None else ws.numel())
        tickets = max(tickets, 0 if tk is None else tk.numel())
        ws = torch.zeros(words, dtype=torch.int32, device=key[0])
        tk = torch.zeros(tickets, dtype=torch.int32, device=key[0])
        _workspaces[key] = ws, tk
    return ws, tk


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
