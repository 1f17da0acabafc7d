"""Cryptojacking injection: a bitcoin-style double-SHA-256 proof-of-work
CPU burner (reference: locust/pow.py:29-38;
``deeprest_tpu/loadgen/burner.py``, whose child runs this file).

The reference injects ``pow.py`` into a running pod so its CPU shows up in
that pod's cadvisor metrics without any traffic to justify it — the anomaly
the estimator is meant to flag. The native equivalent: the burner runs as a
child process that *registers its own pid under a victim component's name*
with the trace collector, so the sampled CPU is attributed to that
component (see native/sns/collector.cpp RegisterProcess).
"""

from __future__ import annotations

import hashlib
import os
import struct
import subprocess
import sys
import time


def proof_of_work(header: bytes, difficulty_bits: int,
                  max_iters: int = 1 << 22, start_nonce: int = 0) -> tuple[int, bytes]:
    """Find a nonce whose double-SHA-256 meets the difficulty target.

    Returns ``(nonce, digest)``; nonce is -1 if ``max_iters`` ran out. The
    loop structure mirrors the reference burner (pow.py:29-38): increment
    nonce, hash(hash(header||nonce)), compare against target.
    """
    target = 1 << (256 - difficulty_bits)
    nonce = start_nonce
    for _ in range(max_iters):
        data = header + struct.pack("<Q", nonce)
        digest = hashlib.sha256(hashlib.sha256(data).digest()).digest()
        if int.from_bytes(digest, "big") < target:
            return nonce, digest
        nonce += 1
    return -1, b""


def burn(duration_s: float, difficulty_bits: int = 28) -> int:
    """Burn CPU for ``duration_s`` seconds; returns hash iterations done."""
    iters = 0
    header = os.urandom(32)
    deadline = time.monotonic() + duration_s
    nonce = 0
    while time.monotonic() < deadline:
        chunk = 20_000
        found, _ = proof_of_work(header, difficulty_bits, max_iters=chunk,
                                 start_nonce=nonce)
        if found < 0:
            iters += chunk
            nonce += chunk
        else:
            iters += found - nonce + 1
            nonce = 0
            header = os.urandom(32)
    return iters


class Burner:
    """Runs the burner as a child process, optionally attributed to a
    victim component via collector registration."""

    def __init__(self, duration_s: float, collector_addr: tuple[str, int] | None = None,
                 component: str | None = None):
        self.duration_s = duration_s
        self.collector_addr = collector_addr
        self.component = component
        self._proc: subprocess.Popen | None = None

    def start(self) -> "Burner":
        # Run the module FILE, not `-m deeprest_tpu_torch...`: the package
        # import chain costs ~2s of child startup, during which a short burn window
        # would produce zero attributed samples.  The file itself only needs
        # the stdlib, so the child starts hashing almost immediately.
        # In a zipped install __file__ is not a real on-disk path — fall
        # back to the (slower) -m invocation, with the package's import
        # root (the zip itself) put on the child's PYTHONPATH: the child
        # does not inherit the parent's sys.path, so without this the -m
        # child would die instantly on ModuleNotFoundError into DEVNULL
        # and the anomaly would silently inject zero load.  (A PyInstaller
        # freeze, where sys.executable is not a Python interpreter at all,
        # is not supported.)
        script = os.path.abspath(__file__)
        env = None
        if os.path.isfile(script):
            cmd = [sys.executable, script, f"--duration={self.duration_s}"]
        else:
            pkg_root = os.path.dirname(os.path.dirname(
                os.path.dirname(script)))
            env = dict(os.environ)
            # No trailing empty entry: CPython reads one as "cwd", which
            # could shadow the real package with a stray checkout.
            existing = env.get("PYTHONPATH")
            env["PYTHONPATH"] = (pkg_root + os.pathsep + existing
                                 if existing else pkg_root)
            cmd = [sys.executable, "-m", "deeprest_tpu_torch.loadgen.burner",
                   f"--duration={self.duration_s}"]
        self._proc = subprocess.Popen(
            cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            env=env,
        )
        if self.collector_addr and self.component:
            # Register from the parent — the child pid is known the moment
            # Popen returns, so attribution starts at t=0 instead of racing
            # the child's interpreter startup.  If registration fails the
            # burner must not keep running unattributed (it would burn CPU
            # that no component's metrics can explain): kill it and re-raise.
            from deeprest_tpu_torch.loadgen.client import register_with_collector

            host, port = self.collector_addr
            try:
                register_with_collector(host, port, self.component,
                                        self._proc.pid)
            except OSError:
                self.stop()
                raise
        return self

    def wait(self) -> None:
        if self._proc is not None:
            self._proc.wait()

    def stop(self) -> None:
        if self._proc is not None and self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()

    def __enter__(self) -> "Burner":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def _main(argv: list[str]) -> int:
    """Standalone entry point.

    Two registration paths exist deliberately: :class:`Burner` registers
    the child pid from the PARENT (no startup race, used by loadgen and
    tests on a shared host), while the ``--collector``/``--component``
    flags here support the reference's in-pod injection route — copying
    this single stdlib-only file into a victim's pod and running it there,
    where no parent exists (reference: locust/pow.py into a pod).
    """
    duration, collector, component = 5.0, None, None
    for arg in argv:
        if arg.startswith("--duration="):
            duration = float(arg.split("=", 1)[1])
        elif arg.startswith("--collector="):
            host, port = arg.split("=", 1)[1].rsplit(":", 1)
            collector = (host, int(port))
        elif arg.startswith("--component="):
            component = arg.split("=", 1)[1]
    if collector and component:
        # Inlined registration (same frame as loadgen.client.register_with_
        # collector) so this file stays stdlib-only and runs copied into a
        # pod with no deeprest_tpu_torch package installed.
        import json
        import socket

        payload = json.dumps({"register": component,
                              "pid": os.getpid()}).encode()
        with socket.create_connection(collector, timeout=2.0) as s:
            s.sendall(struct.pack(">I", len(payload)) + payload)
    burn(duration)
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
