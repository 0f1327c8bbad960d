"""The port's resident session (timg_tpu_torch.serve, ``timg-tpu-torch
--serve``) and the launcher's client, on the CPU.

Each served stream must equal the JAX package's cold stream for the same
argv (tests.test_golden.run_ours) and the port's own cold run.  The
in-thread cases mirror tests/test_serve.py's: the server runs in a
thread, so requests execute off the main thread and the socket-side
interrupt watcher stands in for signal arming.  The launcher cases run
``timg-tpu-torch`` as a subprocess against a server process.
"""

import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")
os.environ["TIMG_TPU_TORCH_DEVICE"] = "cpu"

from tests.test_serve import _png, _raw_request  # noqa: E402
from timg_tpu_torch import serve as serve_mod  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHER = os.path.join(REPO, "timg-tpu-torch")
BASE = ["-pq", "-g40x12", "--debug-no-frame-delay", "-b", "black"]


def _start(sock, max_requests=16):
    ready = threading.Event()
    state = {"rc": None}

    def run():
        state["rc"] = serve_mod.serve(sock, ready_callback=ready.set,
                                      max_requests=max_requests)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert ready.wait(timeout=60), "server did not come up"
    return t, state


@pytest.fixture()
def server(tmp_path):
    sock = str(tmp_path / "srv.sock")
    _start(sock)
    yield sock
    # unblock the accept loop so the thread exits
    try:
        import socket as s
        c = s.socket(s.AF_UNIX, s.SOCK_STREAM)
        c.connect(sock)
        c.close()
    except OSError:
        pass


def _cold_port(argv, out):
    from timg_tpu_torch.cli import main
    assert main(argv + ["-o", str(out)]) in (0, 1)
    return out.read_bytes()


def _served(sock, argv, out):
    assert serve_mod.request(argv + ["-o", str(out)], socket_path=sock) == 0
    return out.read_bytes()


def _three_ways(sock, tmp_path, argv, files, tag="o"):
    """(served, the port's cold run, the JAX package's cold run)."""
    from tests.test_golden import run_ours

    served = _served(sock, argv + files, tmp_path / f"{tag}.served")
    cold = _cold_port(argv + files, tmp_path / f"{tag}.cold")
    return served, cold, run_ours(argv, files)


@pytest.mark.parametrize("mode", [
    pytest.param(["-pq"], id="pq"),
    pytest.param(["-ps", "--dither=cube"], id="cube"),
    pytest.param(["-ps", "--dither=libsixel"], id="libsixel"),
])
def test_served_matches_cold(server, tmp_path, mode):
    png = _png(tmp_path)
    argv = mode + ["-g40x12", "--debug-no-frame-delay", "-b", "black"]
    served, cold, jax_cold = _three_ways(server, tmp_path, argv, [png])
    assert served and served == cold == jax_cold


def test_sequential_requests_stay_correct(server, tmp_path):
    for i in range(3):
        png = _png(tmp_path, f"s{i}.png", seed=10 + i)
        served, cold, jax_cold = _three_ways(server, tmp_path, BASE, [png],
                                             f"s{i}")
        assert served == cold == jax_cold, f"request {i} diverged"


def test_exit_code_propagates(server, tmp_path):
    rc = serve_mod.request(BASE + ["-o", os.devnull,
                                   str(tmp_path / "missing.png")],
                           socket_path=server)
    assert rc == 1  # image read error
    rc = serve_mod.request(["-g0x0", "-o", os.devnull, "x.png"],
                           socket_path=server)
    assert rc == 3  # not a terminal size


def test_relative_path_resolves_against_client_cwd(server, tmp_path):
    from tests.test_golden import run_ours

    png = _png(tmp_path, "rel.png", seed=3)
    jax_cold = run_ours(BASE, [png])
    out = tmp_path / "rel.out"
    prev = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc = serve_mod.request(BASE + ["-o", "rel.out", "rel.png"],
                               socket_path=server)
    finally:
        os.chdir(prev)
    assert rc == 0
    assert out.read_bytes() == jax_cold


def test_env_isolation(server, tmp_path, monkeypatch):
    """A request's env must not leak into the server process: a second
    clean request after one with TIMG_USE_UPPER_BLOCK still matches the
    cold run, and the first honoured its env."""
    from tests.test_golden import run_ours

    png = _png(tmp_path, "envy.png", seed=5)
    jax_cold = run_ours(BASE, [png])
    monkeypatch.setenv("TIMG_USE_UPPER_BLOCK", "1")  # changes bytes
    upper = _cold_port(BASE + [png], tmp_path / "upper.cold")
    out1 = _served(server, BASE + [png], tmp_path / "e1.out")
    monkeypatch.delenv("TIMG_USE_UPPER_BLOCK")
    out2 = _served(server, BASE + [png], tmp_path / "e2.out")
    assert out1 == upper != out2
    assert out2 == jax_cold
    assert "TIMG_USE_UPPER_BLOCK" not in os.environ


def test_device_mismatch_is_delegated(server, tmp_path, monkeypatch):
    png = _png(tmp_path, "poison.png", seed=4)
    monkeypatch.setenv("TIMG_TPU_TORCH_DEVICE", "cuda")
    assert serve_mod.request(BASE + ["-o", os.devnull, png],
                             socket_path=server) is None
    monkeypatch.setenv("TIMG_TPU_TORCH_DEVICE", "CPU ")   # the same device
    assert serve_mod.request(BASE + ["-o", os.devnull, png],
                             socket_path=server) == 0


def test_nested_serve_is_delegated(server):
    assert serve_mod.request(["--serve"], socket_path=server) is None
    assert serve_mod.request(["--serve=x"], socket_path=server) is None


@pytest.mark.parametrize("var", ["CUDA_VISIBLE_DEVICES",
                                 "CUDA_DEVICE_ORDER"])
def test_card_env_mismatch_is_delegated(server, tmp_path, monkeypatch, var):
    """CUDA picks the server's cards once, at its start: a request that
    shows CUDA other cards is delegated, one that shows the same is
    served."""
    png = _png(tmp_path, "cards.png", seed=4)
    argv = BASE + ["-o", os.devnull, png]
    monkeypatch.setenv(var, "2" if var == "CUDA_VISIBLE_DEVICES"
                       else "PCI_BUS_ID")
    assert serve_mod.request(argv, socket_path=server) is None
    monkeypatch.undo()
    assert serve_mod.request(argv, socket_path=server) == 0


def _foreign(uid_of):
    """An ``os.lstat`` that reports paths for which ``uid_of`` holds as
    owned by another user."""
    real = os.lstat

    def lstat(path, *a, **k):
        st = real(path, *a, **k)
        if not uid_of(path):
            return st
        return os.stat_result((*st[:4], st.st_uid + 1, *st[5:]))
    return lstat


def test_foreign_socket_is_never_sent_a_request(server, tmp_path,
                                                monkeypatch):
    """A socket at the path that another user owns, or whose listener
    runs as another uid, is treated as absent: the client sends it
    nothing (no environment, no terminal) and the launcher runs cold."""
    real_lstat = os.lstat
    png = _png(tmp_path, "f.png", seed=4)
    argv = BASE + ["-o", os.devnull, png]
    monkeypatch.setenv("TIMG_TPU_SERVE_SOCKET", server)
    monkeypatch.setattr(serve_mod.os, "lstat",
                        _foreign(lambda p: p == server))
    assert serve_mod.request(argv, socket_path=server) is None
    assert serve_mod.try_serve(argv) is None
    monkeypatch.setattr(serve_mod.os, "lstat", real_lstat)
    sent = []
    monkeypatch.setattr(serve_mod, "_send_fds",
                        lambda conn, fds: sent.append(fds))
    monkeypatch.setattr(serve_mod, "_peer_uid", lambda conn: os.getuid() + 1)
    assert serve_mod.request(argv, socket_path=server) is None
    assert serve_mod.try_serve(argv) is None
    assert sent == []
    monkeypatch.undo()
    assert serve_mod.request(argv, socket_path=server) == 0


def test_not_a_socket_is_never_used(tmp_path, monkeypatch):
    path = tmp_path / "plain"
    path.write_bytes(b"")
    assert serve_mod.request(["-h"], socket_path=str(path)) is None
    monkeypatch.setenv("TIMG_TPU_SERVE_SOCKET", str(path))
    assert serve_mod.try_serve(["-h"]) is None


def test_server_refuses_foreign_peer(server, tmp_path, monkeypatch):
    """A peer of another uid gets no answer and runs nothing; the next
    peer of the server's own uid is served."""
    png = _png(tmp_path, "fp.png", seed=4)
    out = tmp_path / "fp.out"
    argv = BASE + ["-o", str(out), png]
    fd = os.open(os.devnull, os.O_RDWR)
    try:
        monkeypatch.setattr(serve_mod, "_peer_uid",
                            lambda conn: os.getuid() + 1)
        assert _raw_request(server, argv, [fd, fd, fd]) is None
        assert not out.exists()
        monkeypatch.undo()
        assert _raw_request(server, argv, [fd, fd, fd]) == 0
        assert out.read_bytes()
    finally:
        os.close(fd)


def test_socket_is_private_from_its_bind(tmp_path, monkeypatch):
    """The socket is created 0600 (the umask during bind), the process's
    umask is restored, and a path that another user owns is not taken."""
    sock = str(tmp_path / "priv.sock")
    before = os.umask(0o022)
    try:
        modes = []
        real_bind = serve_mod.socket.socket.bind

        def bind(self, path):
            real_bind(self, path)
            modes.append(os.lstat(path).st_mode & 0o777)
        monkeypatch.setattr(serve_mod.socket.socket, "bind", bind)
        assert serve_mod.serve(sock, max_requests=0) == 0
        assert modes == [0o600]
        assert os.umask(0o022) == 0o022
    finally:
        os.umask(before)
    monkeypatch.undo()
    import socket as s
    taken = str(tmp_path / "theirs.sock")
    other = s.socket(s.AF_UNIX, s.SOCK_STREAM)
    other.bind(taken)
    other.close()
    monkeypatch.setattr(serve_mod.os, "lstat",
                        _foreign(lambda p: p == taken))
    assert serve_mod.serve(taken, max_requests=0) == 1
    assert os.path.exists(taken)


def test_absent_server_returns_none(tmp_path, monkeypatch):
    sock = str(tmp_path / "nope.sock")
    assert serve_mod.request(["-pq", "x.png"], socket_path=sock) is None
    monkeypatch.setenv("TIMG_TPU_SERVE_SOCKET", sock)
    assert serve_mod.try_serve(["-pq", "x.png"]) is None


def test_stale_socket_falls_back_fast(tmp_path, monkeypatch):
    """A socket file with no listener: the clients return None at once
    and the launcher renders on its own."""
    import socket as s

    stale = str(tmp_path / "stale.sock")
    srv = s.socket(s.AF_UNIX, s.SOCK_STREAM)
    srv.bind(stale)
    srv.close()  # file remains, nobody listens
    t0 = time.monotonic()
    assert serve_mod.request(["-h"], socket_path=stale) is None
    monkeypatch.setenv("TIMG_TPU_SERVE_SOCKET", stale)
    assert serve_mod.try_serve(["-h"]) is None
    assert time.monotonic() - t0 < 5

    png = _png(tmp_path, "st.png", seed=4)
    out = tmp_path / "st.out"
    r = subprocess.run([sys.executable, LAUNCHER, *BASE, "-o", str(out),
                        png], env=_env(stale), capture_output=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-400:]
    assert out.read_bytes() == _cold_port(BASE + [png], tmp_path / "c")


def test_stale_socket_replaced_by_server(tmp_path):
    import socket as s

    stale = str(tmp_path / "old.sock")
    srv = s.socket(s.AF_UNIX, s.SOCK_STREAM)
    srv.bind(stale)
    srv.close()
    _start(stale, max_requests=1)
    png = _png(tmp_path, "re.png", seed=6)
    assert _served(stale, BASE + [png], tmp_path / "re.out")


def test_live_socket_is_not_taken_over(server):
    assert serve_mod.serve(server, max_requests=0) == 1


def test_wedged_client_does_not_starve_later_requests(tmp_path,
                                                      monkeypatch,
                                                      capfd):
    """A client whose tty is never drained is cut off by the
    per-request watchdog; the next client is served normally (capfd is
    disabled around the wedged request so fd 1 is the real one, as in
    production)."""
    import pty

    from PIL import Image

    from tests.test_golden import run_ours

    monkeypatch.setenv("TIMG_TPU_SERVE_REQUEST_TIMEOUT", "2")
    sock = str(tmp_path / "w.sock")
    t, state = _start(sock, max_requests=2)
    # a sixel stream of noise far larger than the tty buffer
    rng = np.random.default_rng(9)
    big = tmp_path / "big.png"
    Image.fromarray(rng.integers(0, 256, (600, 800, 3), dtype=np.uint8),
                    "RGB").save(big)
    master, slave = pty.openpty()
    devnull = os.open(os.devnull, os.O_RDONLY)
    t0 = time.monotonic()
    with capfd.disabled():
        rc = _raw_request(sock, ["-ps", "-g300x100",
                                 "--debug-no-frame-delay", "-b", "black",
                                 str(big)], [devnull, slave, slave],
                          timeout=60)
    elapsed = time.monotonic() - t0
    os.close(devnull)
    os.close(slave)
    os.close(master)
    assert rc is not None, "watchdog never unwedged the request"
    assert 1.5 <= elapsed < 30, f"unwedge took {elapsed:.1f}s"

    png2 = _png(tmp_path, "after.png", seed=10)
    assert _served(sock, BASE + [png2], tmp_path / "after.out") \
        == run_ours(BASE, [png2])
    t.join(timeout=30)
    assert state["rc"] == 0


def test_request_guard_restores_blocking_stdout(server, tmp_path):
    import fcntl

    png = _png(tmp_path, "fl.png", seed=3)
    r, w = os.pipe()
    devnull = os.open(os.devnull, os.O_RDONLY)
    rc = _raw_request(server, BASE + [png], [devnull, w, w])
    assert rc == 0
    flags = fcntl.fcntl(w, fcntl.F_GETFL)
    os.close(devnull)
    os.close(w)
    os.close(r)
    assert not (flags & os.O_NONBLOCK)


def test_two_interleaved_clients(server, tmp_path):
    from tests.test_golden import run_ours

    pngs = [_png(tmp_path, f"i{i}.png", seed=20 + i) for i in range(2)]
    colds = [run_ours(BASE, [p]) for p in pngs]
    outs = [tmp_path / f"i{i}.out" for i in range(2)]
    rcs = [None, None]

    def go(i):
        rcs[i] = serve_mod.request(BASE + ["-o", str(outs[i]), pngs[i]],
                                   socket_path=server)

    ts = [threading.Thread(target=go, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert rcs == [0, 0]
    for i in range(2):
        assert outs[i].read_bytes() == colds[i], f"client {i} diverged"


def test_request_leaves_no_state(server, tmp_path):
    """What a request opens is released: the -o file's descriptor, the
    thread pools' threads, the plane caches' device frames."""
    from timg_tpu_torch.render import plane_cache

    pngs = [_png(tmp_path, f"n{i}.png", seed=30 + i) for i in range(2)]
    argv = ["-ps", "--dither=cube", "-g40x12", "--debug-no-frame-delay",
            "-b", "black", "-o", str(tmp_path / "n.out")]
    assert serve_mod.request(argv + pngs, socket_path=server) == 0
    fds = len(os.listdir("/proc/self/fd"))
    time.sleep(0.5)     # the previous request's daemon threads wind down
    threads = threading.active_count()
    for _ in range(3):
        assert serve_mod.request(argv + pngs, socket_path=server) == 0
    time.sleep(0.5)
    assert len(os.listdir("/proc/self/fd")) <= fds
    assert threading.active_count() <= threads
    assert not plane_cache.SIXEL_PLANES._entries
    assert not plane_cache.BLOCK_PLANES._entries


def test_socket_paths_differ(monkeypatch, tmp_path):
    """Neither package's client can reach the other's server."""
    from timg_tpu import serve as jax_serve

    monkeypatch.delenv("TIMG_TPU_SERVE_SOCKET", raising=False)
    for xdg in (str(tmp_path), None):
        if xdg:
            monkeypatch.setenv("XDG_RUNTIME_DIR", xdg)
        else:
            monkeypatch.delenv("XDG_RUNTIME_DIR", raising=False)
        ours = serve_mod.default_socket_path()
        theirs = jax_serve.default_socket_path()
        assert ours != theirs
        assert os.path.basename(ours).startswith("timg-tpu-torch")
    assert serve_mod.default_socket_path() == \
        f"/tmp/timg-tpu-torch-{os.getuid()}.sock"


# ---------------------------------------------------------------------------
# The launcher (timg-tpu-torch) against a server process.
# ---------------------------------------------------------------------------

def _env(sock, **extra):
    """The launcher's environment: the CPU asked for, and the host fast
    path (which takes an in-envelope still before the socket) off, so
    each launcher case stays on the route it names; test_launcher_fast_
    path_answers_first turns it back on."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("TIMG_")}
    env.update({"TIMG_TPU_TORCH_DEVICE": "cpu", "TIMG_TPU_NO_FASTPATH": "1",
                "TIMG_TPU_SERVE_SOCKET": sock, **extra})
    return env


@pytest.fixture(scope="module")
def server_proc(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("proc") / "p.sock")
    proc = subprocess.Popen([sys.executable, LAUNCHER, "--serve"],
                            env=_env(sock), cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    deadline = time.time() + 120
    while not os.path.exists(sock):
        if proc.poll() is not None or time.time() > deadline:
            proc.kill()
            pytest.fail("serve process did not come up: "
                        + proc.stderr.read().decode()[-400:])
        time.sleep(0.05)
    yield sock, proc
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()


def _launch(env, argv, out, *flags):
    r = subprocess.run([sys.executable, *flags, LAUNCHER, *argv, "-o",
                        str(out)], env=env, capture_output=True,
                       stdin=subprocess.DEVNULL, timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-400:]
    return out.read_bytes(), r.stderr


@pytest.mark.parametrize("mode", [
    pytest.param(["-pq"], id="pq"),
    pytest.param(["-ps", "--dither=adaptive"], id="adaptive"),
])
def test_launcher_is_served(server_proc, tmp_path, mode):
    """The launcher's request is served (booted as its shebang boots it,
    ``python -S``, it imports no torch) and writes the stream of a run
    with serving off and of the JAX CLI."""
    from tests.test_golden import run_ours

    sock, _ = server_proc
    png = _png(tmp_path, "l.png", seed=12)
    argv = mode + ["-g40x12", "--debug-no-frame-delay", "-b", "black", png]
    served, err = _launch(_env(sock), argv, tmp_path / "srv.out", "-S",
                          "-X", "importtime")
    modules = {line.rsplit("|", 1)[-1].strip()
               for line in err.decode().splitlines()
               if line.startswith("import time:")}
    assert "timg_tpu_torch.serve" in modules
    assert not {"torch", "numpy", "timg_tpu_torch.cli"} & modules
    cold, _ = _launch(_env(sock, TIMG_TPU_NO_SERVE="1"), argv,
                      tmp_path / "cold.out")
    assert served == cold == run_ours(argv[:-1], [png])


def test_launcher_fast_path_answers_first(server_proc, tmp_path):
    """With the CPU asked and the fast path on, the same invocation as
    test_launcher_is_served's pq case is answered by the host fast path
    before the socket (the serve client, which alone connects, is never
    imported; nor are torch and the CLI), with the served bytes."""
    from timg_tpu_torch.utils import device_name

    sock, _ = server_proc
    png = _png(tmp_path, "l.png", seed=12)
    argv = ["-pq", "-g40x12", "--debug-no-frame-delay", "-b", "black", png]
    env = _env(sock)
    del env["TIMG_TPU_NO_FASTPATH"]
    got, err = _launch(env, argv, tmp_path / "fast.out", "-S", "-X",
                       "importtime")
    modules = {line.rsplit("|", 1)[-1].strip()
               for line in err.decode().splitlines()
               if line.startswith("import time:")}
    assert "timg_tpu_torch.fast" in modules
    assert not {"torch", "numpy", "timg_tpu_torch.cli",
                "timg_tpu_torch.serve"} & modules
    served, _ = _launch(_env(sock), argv, tmp_path / "srv.out")
    assert got == served
    assert device_name(env) == "cpu"


def test_launcher_runs_delegated_request_itself(server_proc, tmp_path):
    """A request for another device is delegated; the launcher then
    runs it itself: on a card, or, without one, it fails there for want
    of CUDA (exit 2) and says so on its own stderr."""
    import torch

    sock, _ = server_proc
    png = _png(tmp_path, "d.png", seed=13)
    r = subprocess.run([sys.executable, LAUNCHER, *BASE, "-o",
                        str(tmp_path / "d.out"), png],
                       env=_env(sock, TIMG_TPU_TORCH_DEVICE="cuda"),
                       capture_output=True, timeout=300)
    if torch.cuda.is_available():
        assert r.returncode == 0
    else:
        assert r.returncode == 2
        assert b"CUDA is not available" in r.stderr


def test_launcher_exit_code_is_served(server_proc, tmp_path):
    sock, _ = server_proc
    r = subprocess.run([sys.executable, LAUNCHER, *BASE, "-o", os.devnull,
                        str(tmp_path / "missing.png")], env=_env(sock),
                       capture_output=True, timeout=300)
    assert r.returncode == 1


@pytest.mark.parametrize("flags", [pytest.param([], id="site"),
                                   pytest.param(["-S"], id="no-site")])
def test_launcher_falls_back_when_server_absent(tmp_path, flags):
    """With no server the CLI runs in the launcher's process, or, booted
    without site (its shebang), in the interpreter re-executed with
    site."""
    png = _png(tmp_path, "fb.png", seed=14)
    out, _ = _launch(_env(str(tmp_path / "absent.sock")), BASE + [png],
                     tmp_path / "fb.out", *flags)
    assert out == _cold_port(BASE + [png], tmp_path / "fbc.out")


def test_launcher_runs_as_its_shebang_says(server_proc, tmp_path):
    """Executed directly (``#!/usr/bin/env -S python3 -S``), served and
    with serving off."""
    sock, _ = server_proc
    png = _png(tmp_path, "sb.png", seed=16)
    env = _env(sock, PATH=os.path.dirname(sys.executable) + os.pathsep
               + os.environ.get("PATH", ""))
    outs = []
    for extra in ({}, {"TIMG_TPU_NO_SERVE": "1"}):
        out = tmp_path / f"sb{len(outs)}.out"
        r = subprocess.run([LAUNCHER, *BASE, "-o", str(out), png],
                           env=dict(env, **extra), capture_output=True,
                           stdin=subprocess.DEVNULL, timeout=300)
        assert r.returncode == 0, r.stderr.decode()[-400:]
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] == _cold_port(BASE + [png], tmp_path / "c")


@pytest.fixture
def stub_site(tmp_path):
    """(PYTHONPATH directory, log path) of a ``sitecustomize`` that logs
    whether torch was loaded when it ran and, at exit, by then."""
    d = tmp_path / "site"
    d.mkdir()
    log = tmp_path / "site.log"
    (d / "sitecustomize.py").write_text(textwrap.dedent(f"""
        import atexit, sys
        def _log(what):
            with open({str(log)!r}, "a") as f:
                f.write(what + " torch=" + str("torch" in sys.modules)
                        + "\\n")
        _log("sitecustomize")
        atexit.register(_log, "exit")
    """))
    return str(d), log


def test_cli_run_imports_sitecustomize_before_torch(stub_site, tmp_path):
    """With the fast path off, the CLI runs in the interpreter re-executed
    with site: the customization runs once, before torch is imported.
    A still the fast path answers never runs it, and its bytes are the
    CLI's."""
    png = _png(tmp_path, "sc.png", seed=17)
    env = _env(str(tmp_path / "absent.sock"), PYTHONPATH=stub_site[0])
    cli, _ = _launch(env, BASE + [png], tmp_path / "c.out", "-S")
    assert stub_site[1].read_text() == ("sitecustomize torch=False\n"
                                        "exit torch=True\n")
    del env["TIMG_TPU_NO_FASTPATH"]
    stub_site[1].unlink()
    fast, _ = _launch(env, BASE + [png], tmp_path / "f.out", "-S")
    assert not stub_site[1].exists()
    assert cli == fast and cli


def test_server_stops_and_removes_socket(tmp_path):
    """SIGTERM (also after a request, whose CLI re-arms the defaults)
    and SIGINT end the server and remove its socket."""
    import signal

    for signo in (signal.SIGTERM, signal.SIGINT):
        sock = str(tmp_path / f"stop{signo}.sock")
        proc = subprocess.Popen([sys.executable, LAUNCHER, "--serve"],
                                env=_env(sock), cwd=REPO,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
        deadline = time.time() + 120
        while not os.path.exists(sock) and time.time() < deadline \
                and proc.poll() is None:
            time.sleep(0.05)
        assert os.path.exists(sock), proc.stderr.read().decode()[-400:]
        png = _png(tmp_path, "stop.png", seed=15)
        _launch(_env(sock), BASE + [png], tmp_path / "stop.out")
        proc.send_signal(signo)
        assert proc.wait(timeout=30) == 0
        assert not os.path.exists(sock)


def test_server_without_card_exits_2(tmp_path):
    """Asked for cuda on a host without a card, the server exits 2 with
    the backend's message and never listens."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    sock = str(tmp_path / "nocard.sock")
    r = subprocess.run([sys.executable, LAUNCHER, "--serve"],
                       env=_env(sock, TIMG_TPU_TORCH_DEVICE="cuda"),
                       capture_output=True, timeout=300)
    assert r.returncode == 2
    assert b"CUDA is not available" in r.stderr
    assert not os.path.exists(sock)
