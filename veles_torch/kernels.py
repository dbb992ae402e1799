"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``.
Libraries go to ``veles_torch/build/`` (not committed), named by a hash
of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt and a stale library is never loaded.
The build happens at first use, from the sources in the package only;
:func:`build` compiles several sources at once, one ``nvcc`` process
each.

Nothing here runs at import time: this module is imported on hosts
without ``nvcc`` or a card, where the kernels' plain versions run.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: seconds one nvcc process may take before the build is abandoned
BUILD_TIMEOUT = 600

_libs = {}
#: nvcc's output (ptxas register and spill report) of each build, by name
build_logs = {}


def sources():
    """Names of every kernel source in ``csrc/``."""
    return sorted(f[:-3] for f in os.listdir(SOURCE_DIR) if f.endswith(".cu"))


def nvcc():
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "on a host with the CUDA toolkit")
    return path


def library_path(name):
    """Where the library of ``csrc/<name>.cu`` is (or will be) built: named
    by a hash of the source, every shared header ``csrc/*.cuh`` (a source
    may include any of them) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(SOURCE_DIR) if f.endswith(".cuh"))
    for part in [name + ".cu"] + headers:
        with open(os.path.join(SOURCE_DIR, part), "rb") as f:
            digest.update(part.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, "lib%s-%s.so"
                        % (name, digest.hexdigest()[:16]))


def _nvcc_start(src, out):
    """An nvcc process building ``src`` into the library ``out``, with
    ``csrc/`` on the include path (the shared headers)."""
    return subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-I", SOURCE_DIR, "-o", out, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_copies(texts, out_dir):
    """Compile kernel sources given as text ({name: text}, e.g. two
    versions of one ``csrc/*.cu`` to compare) into
    ``out_dir/lib<name>.so``, all at once, with :func:`build`'s flags;
    each log goes to ``out_dir/nvcc_<name>.log``. -> {name: library
    path}. Raises if any build fails."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    failed = []
    try:
        for name, text in texts.items():
            src = os.path.join(out_dir, "%s.cu" % name)
            with open(src, "w") as f:
                f.write(text)
            procs[name] = _nvcc_start(
                src, os.path.join(out_dir, "lib%s.so" % name))
        for name, proc in procs.items():
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT)
            with open(os.path.join(out_dir, "nvcc_%s.log" % name), "w") as f:
                f.write(log)
            if proc.returncode:
                failed.append("%s:\n%s" % (name, log))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed for %s" % "\n".join(failed))
    return {name: os.path.join(out_dir, "lib%s.so" % name)
            for name in texts}


def build(names=None):
    """Compile every named source (default: all) that is not built yet,
    all ``nvcc`` processes started together. -> {name: seconds} for the
    sources built by this call. Raises if any build fails."""
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    seconds = {}
    failed = []
    try:
        for name in names:
            out = library_path(name)
            if os.path.exists(out):
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            procs[name] = (_nvcc_start(
                os.path.join(SOURCE_DIR, name + ".cu"), tmp), tmp, out)
        for name, (proc, tmp, out) in procs.items():
            build_logs[name], _ = proc.communicate(timeout=BUILD_TIMEOUT)
            seconds[name] = time.perf_counter() - t0
            if proc.returncode:
                failed.append(name)
                os.unlink(tmp)
            else:
                # atomic: a concurrent builder never loads a partial file
                os.replace(tmp, out)
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise RuntimeError("nvcc failed for %s:\n%s" % (
            ", ".join(failed),
            "\n".join(build_logs.get(n, "") for n in failed)))
    return seconds


def open_library(path, signatures):
    """``ctypes.CDLL(path)`` with ``signatures`` ({function: (restype,
    [argtypes])}) declared (a pointer argument must be ``c_void_p``, or
    ctypes cuts it to 32 bits)."""
    lib = ctypes.CDLL(path)
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def load(name, signatures):
    """The ``ctypes`` library of ``csrc/<name>.cu``, built if needed, with
    ``signatures`` declared (:func:`open_library`)."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build([name])
        lib = open_library(path, signatures)
        _libs[name] = lib
    return lib
