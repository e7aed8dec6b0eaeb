"""Build the package's CUDA kernels at first use and load them with ctypes.

Every `csrc/*.cu` file is compiled by its own `nvcc` process, all started
together, and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). Code shared
between sources lives in `csrc/*.cuh` headers. The library lands in
`unpaired_image_captioning_tpu_torch/_build/`, named by a hash of the
sources, the headers and the flags, so an edited source or header rebuilds
and an unchanged tree loads the cached file. Pointers and the stream are
passed as `c_void_p`, sizes as `c_int`; each C function returns
`cudaGetLastError()` after its launch and `check` raises on a non-zero
code.

Nothing here runs at import time: the CPU tests import every module of the
package on machines without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_L = ctypes.c_longlong
# name -> argtypes of the C entry points in csrc/
SIGNATURES = {
    # x, h, c, w, b, h_out, c_out, B, D, H, G, types (x, (w, b), (h, c)
    # each f32 or bf16, not all bf16), stream
    "lstm_cell_mixed": (_P,) * 7 + (_I,) * 5 + (_P,),
    # x, h, c, w, b, h_out, c_out, B, D, H, G, stream: every tensor bf16,
    # on the tensor-core instance
    "lstm_cell_bf16_tc": (_P,) * 7 + (_I,) * 4 + (_P,),
    # B, D, H, out int[4]: the tensor-core instance's plan
    "lstm_cell_tc_plan": (_I, _I, _I, _P),
    # the same with plan()'s tile and no cluster (the cluster's yardstick)
    "lstm_cell_f32_unclustered": (_P,) * 7 + (_I,) * 4 + (_P,),
    # B, D, H, out int[4] (BN, cluster size, K rows a block, blocks)
    "lstm_cell_f32_plan": (_I, _I, _I, _P),
    # x, vals, idx, R, V, k, stream
    "row_topk_f32": (_P, _P, _P, _I, _I, _I, _P),
    # x, vals, idx, R, V, k, stream
    "chunked_topk_f32": (_P, _P, _P, _I, _I, _I, _P),
    # x_in, x_out, t, ck, cv, mask, cache_k, cache_v, anc, w[18] (host
    # array), q, att, h1, attn_h, attn, R, B, S, d, T, d_ff, H, L, fl (the
    # TFD_* types: x, the weights, the caches, the memory each f32 or
    # bf16), route (host int: the TFD_ROUTE_* bits the step ran), stream
    "tfd_stack_step_mixed": (_P,) * 15 + (_I,) * 9 + (_P, _P),
    # x_in, x_out, t, ck, cv, mask, cache_k, cache_v, w[18] (host array),
    # q, att, h1, R, B, S, d, T, d_ff, H, fl, route, stream
    "tfd_layer_step_mixed": (_P,) * 12 + (_I,) * 8 + (_P, _P),
    # q, k, v, mask, seed, out, stats, B, T, S, H, dh, mask_rows, thresh,
    # keep_div, dropout, fl (the ATT_* types), stream
    "mha_train_fwd_mixed": (_P,) * 7 + (_I,) * 6 + (_U, _F, _I, _I, _P),
    # q, k, v, mask, seed, g, o, stats, dq, dk, dv, scratch, its bytes, B,
    # T, S, H, dh, mask_rows, thresh, keep_div, dropout, fl, stream
    "mha_train_bwd_mixed": (_P,) * 12 + (_L,) + (_I,) * 6
    + (_U, _F, _I, _I, _P),
    # B, T, S, H, tc (the tensor-core instance), out int64 [1] -> bytes of
    # the backward's scratch
    "mha_train_bwd_ws_bytes": (_I,) * 5 + (_P,),
    # x, scale, offset, y, rows, d, eps, fl (the LN_* types), stream
    "ln_train_fwd_mixed": (_P,) * 4 + (_I, _I, _F, _I, _P),
    # x, scale, g, dx, dscale, doffset, ws, rows, d, eps, fl, stream
    "ln_train_bwd_mixed": (_P,) * 7 + (_I, _I, _F, _I, _P),
    # d, out int64 [1] -> floats of the backward's scratch
    "ln_train_bwd_ws_f32": (_I, _P),
    # kind, B, T, S, d, f, H, bf, out int64 [1] -> floats of a layer
    # backward's scratch
    "layer_train_ws_f32": (_I,) * 8 + (_P,),
    # M, N, K, bf (the bf16 tensor-core instance), out int[4] (row tiles in
    # whole rounds, row tiles, cluster size of the rest, its clusters at
    # once) of a training-layer product
    "layer_train_gemm_plan": (_I,) * 4 + (_P,),
    # p (host array of the layer's tensors), B, T, d, f, H, mask_rows,
    # thresh, keep_div, dropout, bf (every tensor bf16 but the masks and
    # the softmax statistics)[, ws], stream
    "enc_layer_fwd_mixed": (_P,) + (_I,) * 6 + (_U, _F, _I, _I, _P),
    "enc_layer_bwd_mixed": (_P,) + (_I,) * 6 + (_U, _F, _I, _I, _P, _P),
    # p, B, T, S, d, f, H, tgt mask_rows, thresh, keep_div, dropout, bf[,
    # ws], stream
    "dec_layer_fwd_mixed": (_P,) + (_I,) * 7 + (_U, _F, _I, _I, _P),
    "dec_layer_bwd_mixed": (_P,) + (_I,) * 7 + (_U, _F, _I, _I, _P, _P),
    # p_att, q, alpha, mask, emb, out, B, N, A, D, K, ldo, types (each
    # operand f32 or bf16), stream
    "additive_attention_mixed": (_P,) * 6 + (_I,) * 7 + (_P,),
    # B, N, A, D, K, out int[4] (cluster size, queries a group, groups,
    # shared memory bytes a block)
    "additive_attention_plan": (_I,) * 5 + (_P,),
    # in (host array of 15 inputs), h1, c1, att2, ws, B, N, A, D, H, types
    # (each input f32 or bf16), stream
    "att_lstm_att_mixed": (_P,) * 5 + (_I,) * 6 + (_P,),
    # img, row_idx, row_w, col_idx, col_w, mean, std, out, B, H, W, C, Ho,
    # Wo, obf (out bf16), stream
    "image_front_end_mixed": (_P,) * 8 + (_I,) * 7 + (_P,),
    # x, h0, c0, w, hs, cs, gates, T, B, H, G, types (the carry, w each
    # f32 or bf16), stream
    "lstm_chain_fwd_mixed": (_P,) * 7 + (_I,) * 5 + (_P,),
    # gates, cs, c0, dhs, dcs, w, dgates, dh0, dc0, ws, T, B, H, G, types,
    # stream
    "lstm_chain_bwd_mixed": (_P,) * 10 + (_I,) * 5 + (_P,),
    # B, H, out int64 [1] -> floats of the chain backward's workspace
    "lstm_chain_bwd_ws_f32": (_I, _I, _P),
    # H -> blocks of a chain launch (0: too wide)
    "lstm_chain_blocks": (_I,),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of the build or cache load
build_log: str = ""                  # nvcc's output (ptxas register counts)


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def _digest(srcs: list[Path]) -> str:
    """A hash of the flags, the sources and the headers they include, so an
    edited header rebuilds too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for s in srcs + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]], out_dir: str) -> str:
    """Run the commands at once; raise if any fails. Returns their output."""
    outs = [Path(out_dir) / f"nvcc-{i}.log" for i in range(len(cmds))]
    procs = []
    for cmd, out in zip(cmds, outs):
        with open(out, "w") as f:
            procs.append(subprocess.Popen(cmd, stdout=f,
                                          stderr=subprocess.STDOUT))
    codes = [p.wait() for p in procs]
    logs = [out.read_text() for out in outs]
    for cmd, code, text in zip(cmds, codes, logs):
        if code != 0:
            raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n"
                               f"{text}")
    return "".join(logs)


def _build(srcs: list[Path], so: Path) -> str:
    """Compile every source to an object, one nvcc each, all at once; link
    the objects into `so`. The library is linked under a temporary name and
    renamed, so a concurrent process never loads a half-written one.
    Returns nvcc's output."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{s.stem}.o") for s in srcs]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)]
                        for s, o in zip(srcs, objs)], tmp)
        lib = str(Path(tmp) / "kernels.so")
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", lib, *objs]], tmp)
        os.replace(lib, so)
    return log


def load() -> ctypes.CDLL:
    """Return the kernel library, building it first if it is not cached."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        srcs = _sources()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"kernels-{_digest(srcs)}.so"
        if not so.exists():
            build_log = _build(srcs, so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        build_seconds = time.perf_counter() - t0
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {err}")
