"""ctypes binding of the port's native host runtime (the C++ under `native/`).

- `load_batch(rgb_paths, depth_paths, out_h, out_w)`: grayscale JPEG and
  16-bit PNG depth decode, resized, on threads straight into numpy buffers
  (the `use_native` path of `data/tuples.py::MatchingTupleDataset`);
  `load_gray`, `load_depth`, `jpeg_size` and `png_size` read one file;
- `overlap_matrix(depths, poses, intr, stride)`: the pairwise scene overlap
  that the tuple sampler's candidate JSONs come from;
- `overlap_tool()`: the `emvm_overlap` executable, which writes those JSONs
  for a ScanNet-format tree (`emvm_overlap <dataset_dir> <split> [min] [max]
  [stride]`).

Counterpart of `e2e_multi_view_matching_tpu/data/native_loader.py`: the same
functions on this package's copy of the same C++ sources, compiled with the
flags that the JAX package's CMake Release build passes (`-O3 -march=native
-std=gnu++17 -fPIC`: CMake's C++17 with its default GNU extensions), so the
two give the same bits on one machine.
The host compiler (`$CXX`, else `c++`) builds the library and the tool at
first use into `build/native/` at the repository root, named by a hash of the
sources and flags, under a file lock and renamed into place, so processes
that ask at once build it once. `python -m
e2e_multi_view_matching_tpu_torch.data.native_loader build` builds them ahead.
`available()` is true when they are built or build now; after a failed build
it is false, and every entry point raises with the compiler's message.
"""

import ctypes
import fcntl
import hashlib
import os
import signal
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
LIB_SOURCES = ("src/image_io.cpp", "src/overlap.cpp", "src/capi.cpp")
TOOL_SOURCES = ("tools/emvm_overlap_main.cpp", "src/image_io.cpp", "src/overlap.cpp")
HEADERS = ("src/image_io.h", "src/overlap.h")
CXX_FLAGS = ["-O3", "-march=native", "-std=gnu++17", "-fPIC"]
LINK_FLAGS = ["-ljpeg", "-lpng", "-pthread"]

_lock = threading.Lock()
_lib = None
_tool = None
_error = None


def _compiler():
    return os.environ.get("CXX") or "c++"


def _outputs(build_dir):
    """(library path, tool path) under `build_dir`, named by a hash of the
    sources, the headers and the flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    for name in sorted(set(LIB_SOURCES + TOOL_SOURCES + HEADERS)):
        digest.update(name.encode() + (SRC_DIR / name).read_bytes())
    tag = digest.hexdigest()[:16]
    return build_dir / f"libemvm_native_{tag}.so", build_dir / f"emvm_overlap_{tag}"


def build():
    """Compile the library and the `emvm_overlap` tool into `BUILD_DIR` unless
    they are built, the two compiles side by side. Returns (library path,
    tool path); raises RuntimeError with the compiler's output when either
    fails."""
    lib, tool = _outputs(BUILD_DIR)
    if lib.exists() and tool.exists():
        return lib, tool
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        jobs = []
        try:
            for out, sources, extra in ((lib, LIB_SOURCES, ["-shared"]),
                                        (tool, TOOL_SOURCES, [])):
                if out.exists():  # built by another process meanwhile
                    continue
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                cmd = [_compiler(), *CXX_FLAGS, *extra, "-o", str(tmp),
                       *(str(SRC_DIR / s) for s in sources), *LINK_FLAGS]
                try:  # a session of its own, so that a kill reaches the compiler's children
                    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True,
                                            start_new_session=True)
                except OSError as e:
                    raise RuntimeError(f"cannot run the C++ compiler: {e}") from None
                jobs.append((proc, tmp, out, cmd))
            failed = []
            for proc, tmp, out, cmd in jobs:  # every compile runs to its end
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"`{' '.join(cmd)}` exited {proc.returncode}:\n{log}")
                else:
                    os.replace(tmp, out)
            if failed:
                raise RuntimeError("\n".join(failed))
        finally:
            for proc, tmp, _, _ in jobs:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
                tmp.unlink(missing_ok=True)
    return lib, tool


def _load():
    global _lib, _tool, _error
    with _lock:
        if _lib is None:
            if _error is not None:
                raise RuntimeError(_error)
            try:
                lib_path, _tool = build()
                lib = ctypes.CDLL(str(lib_path))
            except (RuntimeError, OSError) as e:
                _error = f"the native runtime did not build or load: {e}"
                raise RuntimeError(_error) from None
            lib.emvm_load_gray_jpeg.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ]
            lib.emvm_load_depth_png.argtypes = lib.emvm_load_gray_jpeg.argtypes
            lib.emvm_jpeg_size.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ]
            lib.emvm_png_size.argtypes = lib.emvm_jpeg_size.argtypes
            lib.emvm_load_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int,
            ]
            lib.emvm_overlap_matrix.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ]
            _lib = lib
        return _lib


def available():
    """True when the library is built or builds now."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def overlap_tool():
    """Path of the `emvm_overlap` executable, building it if needed."""
    _load()
    return str(_tool)


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def jpeg_size(path):
    lib = _load()
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.emvm_jpeg_size(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        raise IOError(f"failed to read {path}")
    return h.value, w.value


def png_size(path):
    lib = _load()
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.emvm_png_size(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        raise IOError(f"failed to read {path}")
    return h.value, w.value


def load_gray(path, out_h, out_w):
    """A JPEG as grayscale float32 in [0, 1], bilinearly resized to out_h x out_w."""
    lib = _load()
    out = np.empty((out_h, out_w), np.float32)
    if lib.emvm_load_gray_jpeg(path.encode(), _fp(out), out_h, out_w) != 0:
        raise IOError(f"failed to decode {path}")
    return out


def load_depth(path, out_h, out_w):
    """A 16-bit millimetre PNG as float32 meters, nearest-resized to out_h x out_w."""
    lib = _load()
    out = np.empty((out_h, out_w), np.float32)
    if lib.emvm_load_depth_png(path.encode(), _fp(out), out_h, out_w) != 0:
        raise IOError(f"failed to decode {path}")
    return out


def load_batch(rgb_paths, depth_paths, out_h, out_w, n_threads=0):
    """Threaded batch decode: (images (n, H, W) in [0, 1], depths (n, H, W)
    in meters), on `n_threads` threads (default: one a file pair, at most
    one a core)."""
    lib = _load()
    n = len(rgb_paths)
    images = np.empty((n, out_h, out_w), np.float32)
    depths = np.empty((n, out_h, out_w), np.float32)
    if n_threads <= 0:
        n_threads = min(n, os.cpu_count() or 1)
    rgb_arr = (ctypes.c_char_p * n)(*[p.encode() for p in rgb_paths])
    dep_arr = (ctypes.c_char_p * n)(*[p.encode() for p in depth_paths])
    failed = lib.emvm_load_batch(rgb_arr, dep_arr, n, out_h, out_w, _fp(images),
                                 _fp(depths), n_threads)
    if failed:
        raise IOError(f"{failed} of {n} batch loads failed")
    return images, depths


def overlap_matrix(depths, poses, intr, stride=8, depth_consistency=0.1,
                   n_threads=0):
    """Pairwise symmetric-mean overlap matrix.

    Args:
        depths: (n, h, w) float32 meters; poses: (n, 4, 4) cam->world;
        intr: (n, 3, 3) (or 4 x 4, of which the top left 3 x 3 is read).
    Returns:
        (n, n) float32 overlaps in [0, 1].
    """
    lib = _load()
    depths = np.ascontiguousarray(depths, np.float32)
    poses = np.ascontiguousarray(poses, np.float64)
    intr = np.ascontiguousarray(intr[..., :3, :3], np.float64)
    n, h, w = depths.shape
    out = np.empty((n, n), np.float32)
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    lib.emvm_overlap_matrix(_fp(depths), _dp(poses), _dp(intr), n, h, w, stride,
                            ctypes.c_float(depth_consistency), _fp(out), n_threads)
    return out


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "build":
        print("\n".join(map(str, build())))
