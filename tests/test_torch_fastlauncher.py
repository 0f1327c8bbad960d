"""The port's pure-C one-shot launcher (timg-tpu-torch-fast, built from
timg_tpu_torch/native/timg_fast_main.cc) against its python launcher
(timg-tpu-torch), over tests/test_fastlauncher.py's matrices of PNG
stills, errors, filelists, environment knobs, scroll pans and terminal
queries (JPEG, GIF and BMP stills are in
tests/test_torch_fastlauncher_decoders.py; contact sheets and
animations in tests/test_torch_fastlauncher_media.py).

With TIMG_TPU_TORCH_DEVICE=cpu both launchers must give the same
(output bytes, stderr, exit code): inside its envelope the binary
renders on the host, outside it hands the invocation to the resident
server or execs the python launcher.  The python launcher takes its own
fast path, then the server, then the CLI.  A cold CLI start imports
torch (seconds here), so one warm CPU server (``timg-tpu-torch
--serve`` on a socket in a temp dir) answers every invocation that
reaches the CLI, from either launcher, as it does on a user's host with
a server up; tests/test_torch_serve.py holds a served stream to the cold
one.  Then the routes: without the CPU asked the binary renders
nothing on the host and its request is served; with it, an in-envelope
still never connects; a socket of another uid, a listener of another
uid and a path that is not a socket are never sent a byte.

Tolerance: none -- byte equality (kitty ids, clock-seeded, compared
modulo id).
"""

from __future__ import annotations

import os
import random
import re
import socket
import subprocess
import sys
import threading
import time

import pytest

from tests.corpus import build_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY_LAUNCHER = os.path.join(REPO, "timg-tpu-torch")
NATIVE = os.path.join(REPO, "timg_tpu_torch", "native")

_BASE_ENV = {k: v for k, v in os.environ.items()
             if not k.startswith("TIMG_")}
_BASE_ENV.pop("TERM_PROGRAM", None)
_BASE_ENV["TERM"] = "xterm-256color"


@pytest.fixture(scope="module")
def binary():
    from timg_tpu_torch.native import runtime

    path = runtime.build_launcher()
    assert path is not None, runtime.build_error("launcher")[-2000:]
    assert runtime.launcher_fresh()
    return path


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """A warm CPU server for the invocations that reach the CLI."""
    sock = str(tmp_path_factory.mktemp("srv") / "s.sock")
    env = dict(_BASE_ENV, TIMG_TPU_TORCH_DEVICE="cpu",
               TIMG_TPU_SERVE_SOCKET=sock)
    proc = subprocess.Popen([sys.executable, PY_LAUNCHER, "--serve"],
                            env=env, cwd=REPO, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    deadline = time.time() + 180
    while not os.path.exists(sock):
        if proc.poll() is not None or time.time() > deadline:
            proc.kill()
            pytest.fail("the server did not come up: "
                        + proc.stderr.read().decode()[-400:])
        time.sleep(0.05)
    yield sock
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()


@pytest.fixture(scope="module")
def cpu_env(server):
    return dict(_BASE_ENV, TIMG_TPU_TORCH_DEVICE="cpu",
                TIMG_TPU_SERVE_SOCKET=server)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return build_corpus(str(tmp_path_factory.mktemp("corpus")))


def _norm(data: bytes) -> bytes:
    # kitty image ids are clock-seeded (ref kitty-canvas.cc:48-53)
    return re.sub(rb"i=\d+", b"i=ID", data)


def _read(path):
    if not os.path.exists(path):
        return b""
    with open(path, "rb") as f:
        return f.read()


def _run(cmd, args, files, out, env):
    r = subprocess.run([cmd, *args, "-o", out, *files], env=env,
                       capture_output=True, stdin=subprocess.DEVNULL,
                       timeout=300)
    return r.returncode, _norm(_read(out)), r.stderr


def _both(binary, args, files, tmp_path, env):
    return (_run(binary, args, files, str(tmp_path / "c.out"), env),
            _run(PY_LAUNCHER, args, files, str(tmp_path / "py.out"), env))


# ---------------------------------------------------------------------
# In-envelope matrix: every mode and the block path's option surface
# ---------------------------------------------------------------------
MATRIX = [
    ["-pq", "-g80x24", "--debug-no-frame-delay", "-b", "black"],
    ["-ph", "-g40x20", "-b", "#336699"],
    ["-pq", "-g40x20", "-b", "teal", "--color8"],
    ["-pq", "-g40x20", "-b", "none"],
    ["-pq", "-g40x20", "-b", "rgb(10, 20, 30)"],
    ["-pq", "-g40x20", "-b", "rgb(0x80,0x10,0xff)"],
    ["-pq", "-g40x20", "-a", "-W", "-U"],
    ["-pq", "-g40x20", "--upscale=i", "-b", "black"],
    ["-pq", "-g40x20", "-b", "black", "--title", "-C"],
    ["-pq", "-g40x20", "-b", "black", "--title=%b %wx%h (%D)"],
    ["-pq", "-g40x20", "-b", "black", "--title", "--title", "--title"],
    ["-ph", "-g40x20", "-B", "gray", "--pattern-size", "2"],
    ["-pq", "-g40x20", "-b", "black", "--clear"],
    ["-pq", "-g40x20", "-b", "black", "--clear=every"],
    ["-pq", "-g40x20", "-b", "black", "-E"],
    ["-pq", "-g40x20", "-b", "black", "-t", "0"],
    ["-pq", "-g40x20", "-b", "black", "--rotate", "off"],
    ["-ps", "-g40x20", "-b", "black"],
    ["-ps", "-g40x20", "-b", "none"],
    ["-pi", "-g40x20"],
    ["-pi", "-g40x20", "-b", "white", "--compress=6"],
    ["-pk", "-g40x20"],
    ["-pk", "-g40x20", "-b", "black", "--compress=0"],
    ["-pq", "-g39x19", "-b", "black", "-C"],   # odd geometry + center
]


@pytest.mark.parametrize("flags", MATRIX, ids=[" ".join(m) for m in MATRIX])
def test_matrix_matches_python_launcher(binary, cpu_env, corpus, flags,
                                        tmp_path):
    files = [corpus["noise_512x512.png"], corpus["alpha_80x100.png"]]
    c, py = _both(binary, flags, files, tmp_path, cpu_env)
    assert c == py
    assert c[0] == 0 and c[1]


def test_multifile_and_missing(binary, cpu_env, corpus, tmp_path):
    files = ["/nonexistent.png", corpus["noise_64x48.png"], "/tmp",
             corpus["gradient_320x200.png"]]
    c, py = _both(binary, ["-pq", "-g40x20", "-b", "black"], files,
                  tmp_path, cpu_env)
    assert c == py
    assert c[0] == 1


@pytest.mark.parametrize("args,files", [
    (["-pq", "-g40x20"], []),                 # no files -> exit 1
    (["-pq", "-gbogus"], ["IMG"]),            # invalid size -> exit 2
    (["-pq", "-g40x20", "--clear=x"], ["IMG"]),
    (["-pq", "-g40x20", "--rotate=x"], ["IMG"]),
    (["-pq", "-g0x0"], ["IMG"]),              # unusual size -> exit 3
    (["-pq", "-g", "-W"], ["IMG"]),   # argparse "expected one argument"
    (["-pq", "-g40x20", "-b"], ["IMG"]),
    (["-pq", "-g40x20", "-w", "-1", "-b", "black"], ["IMG"]),
    (["-pq", "-g40x20", "--center=x", "-b", "black"], ["IMG"]),
    (["-pq", "-g40x20", "--color8=1", "-b", "black"], ["IMG"]),
])
def test_error_paths(binary, cpu_env, corpus, args, files, tmp_path):
    files = [corpus["noise_64x48.png"] if f == "IMG" else f for f in files]
    c, py = _both(binary, args, files, tmp_path, cpu_env)
    assert c == py


def test_filelist_inputs(binary, cpu_env, corpus, tmp_path):
    img = corpus["noise_64x48.png"]
    # -F resolves relative entries against the filelist's directory
    rel_listing = os.path.join(os.path.dirname(img), "rel.lst")
    with open(rel_listing, "w") as f:
        f.write(os.path.basename(img) + "\n\n"
                + corpus["gradient_320x200.png"] + "\n")
    try:
        c, py = _both(binary, ["-pq", "-g40x20", "-b", "black", "-F",
                               rel_listing], [], tmp_path, cpu_env)
        assert c == py and c[0] == 0
        c, py = _both(binary, ["-pq", "-g40x20", "-b", "black", "-f",
                               "/nonexistent.lst"], [], tmp_path, cpu_env)
        assert c == py
        assert c[0] == 5
    finally:
        os.unlink(rel_listing)


def test_env_knobs(binary, cpu_env, corpus, tmp_path):
    img = corpus["alpha_80x100.png"]
    for extra_env in ({"TIMG_USE_UPPER_BLOCK": "on"},
                      {"TIMG_PIXELATION": "h"},
                      {"TIMG_FONT_WIDTH_CORRECT": "0.75"},
                      {"TIMG_DEFAULT_TITLE": "%b!"},
                      {"TIMG_TPU_TORCH_DEVICE": " CPU "},
                      {"TIMG_TPU_NO_FASTPATH": "1"},
                      {"TIMG_TPU_NO_NATIVE_LAUNCHER": "1"}):
        args = ["-g40x20", "-b", "black"]
        if "TIMG_PIXELATION" not in extra_env:
            args.insert(0, "-pq")
        if "TIMG_DEFAULT_TITLE" in extra_env:
            args.append("--title")
        c, py = _both(binary, args, [img], tmp_path,
                      dict(cpu_env, **extra_env))
        assert c == py, extra_env
        assert c[0] == 0 and c[1]


def test_resize_exec_knob_parity(binary, cpu_env, corpus, tmp_path):
    """TIMG_TPU_RESIZE_EXEC picks the vertical-first executor; every
    value writes the same bytes (-g80x48 on the 512x512 image is a
    vertical-first geometry; -U adds the upsample branch)."""
    for args, src in ((["-pq", "-g80x48", "-b", "black"],
                       corpus["noise_512x512.png"]),
                      (["-pk", "-g80x48", "-b", "black"],
                       corpus["noise_512x512.png"]),
                      (["-pq", "-g80x48", "-b", "black", "-U"],
                       corpus["noise_64x48.png"])):
        outs = set()
        for knob in ("", "scatter", "gather"):
            env = dict(cpu_env, TIMG_TPU_RESIZE_EXEC=knob)
            rc, out, err = _run(binary, args + ["--debug-no-frame-delay"],
                                [src], str(tmp_path / "knob.out"), env)
            assert rc == 0, err[-300:]
            outs.add(out)
        assert len(outs) == 1, args


FUZZ_POOL = [
    ["-pq"], ["-ph"], ["-ps"], ["-pi"], ["--color8"],
    ["-b", "red"], ["-b", "none"], ["-b", "#357"],  # #357 warns -> full
    ["-B", "#334455"], ["--pattern-size", "2"],
    ["--title"], ["--title=%b %wx%h"], ["-W"], ["--center"], ["-U"],
    ["--upscale=i"], ["--rotate", "off"], ["--compress=5"], ["--clear"],
    ["-E"], ["-a"], ["-w", "0"], ["-t", "5"], ["--loops=2"], ["-I"],
    ["--threads", "2"],
]


def test_random_flag_combinations(binary, cpu_env, corpus, tmp_path):
    rng = random.Random(11)
    files = [corpus["noise_64x48.png"], corpus["alpha_80x100.png"]]
    for _ in range(14):
        flags = []
        for f in rng.sample(FUZZ_POOL, rng.randint(1, 4)):
            flags.extend(f)
        flags += ["-g40x12", "--debug-no-frame-delay"]
        c, py = _both(binary, flags, [rng.choice(files)], tmp_path, cpu_env)
        assert c == py, flags


@pytest.mark.parametrize("flags", [
    ["-pq", "-g40x20", "-b", "black", "--scroll", "-t", "0.4"],
    ["-pq", "-g40x20", "-b", "black", "--scroll=20", "-d", "2:1", "-t",
     "0.3"],
    ["-ph", "-g40x20", "-b", "black", "--scroll", "-d", "-3:0",
     "--loops=1"],
    ["-pq", "-g40x20", "-b", "black", "--scroll", "-d", "0:2",
     "--loops=1"],
    ["-pq", "-g40x20", "-b", "black", "--scroll", "-d", "0:0", "-t",
     "0.1"],                                   # warns, shows the still
    ["-pq", "-g40x20", "-b", "black", "--scroll", "-d", "bogus"],  # 2
    ["-pq", "-g30x10", "-b", "none", "--scroll", "-d", "5:3",
     "--loops=1", "--title"],
])
def test_scroll_matches_python_launcher(binary, cpu_env, corpus, flags,
                                        tmp_path):
    for name in ("gradient_320x200.png", "noise_64x48.png"):
        c, py = _both(binary, flags + ["--debug-no-frame-delay"],
                      [corpus[name]], tmp_path, cpu_env)
        assert c == py, (name, flags)


# ---------------------------------------------------------------------
# Terminal queries under scripted ptys: the C query engine resolves the
# same pixelation and writes the same bytes as term.py
# ---------------------------------------------------------------------
_PTY_WINSIZE = (24, 80, 640, 384)  # 8x16 px cells


def _pty_launcher(cmd, args, files, answers, out_path, env):
    import fcntl
    import pty
    import struct
    import termios

    master, slave = pty.openpty()
    fcntl.ioctl(slave, termios.TIOCSWINSZ,
                struct.pack("HHHH", *_PTY_WINSIZE))

    def pump():
        try:
            while True:
                data = os.read(master, 4096)
                if not data:
                    return
                for trigger, reply in answers.items():
                    if trigger in data:
                        os.write(master, reply)
        except OSError:
            return

    threading.Thread(target=pump, daemon=True).start()
    try:
        r = subprocess.run([cmd, *args, "-o", out_path, *files], env=env,
                           stdin=slave, stdout=slave, stderr=slave,
                           timeout=300)
    finally:
        os.close(slave)
        os.close(master)
    return r.returncode, _norm(_read(out_path))


_TERMS = {
    "kitty": {b"\033[>q": b"\033P>|kitty(0.26.5)\033\\\033[0n",
              b"\033]11;?": b"\033]11;rgb:0000/0000/0000\033\\"},
    "iterm2": {b"\033[>q": b"\033P>|iTerm2 3.4.19\033\\\033[0n",
               b"\033]11;?": b"\033]11;rgb:1111/2222/3333\033\\"},
    "xterm-sixel": {b"\033[>q": b"\033P>|XTerm(380)\033\\\033[0n",
                    b"\033[c": b"\033[?64;1;2;4;6;9;15;16;17;18;21;22c",
                    b"\033]11;?": b"\033]11;rgb:0000/0000/0000\033\\"},
    "dumb": {b"\033[>q": b"\033[0n"},
    "foot": {b"\033[>q": b"\033P>|foot(1.16.2)\033\\\033[0n",
             b"\033]11;?": b"\033]11;rgb:0000/0000/0000\033\\"},
    "wezterm": {b"\033[>q":
                b"\033P>|WezTerm 20230712-072601-f4abf8fd\033\\\033[0n",
                b"\033]11;?": b"\033]11;rgb:0000/0000/0000\033\\"},
}


def _pty_both(binary, args, files, answers, tmp_path, env):
    c = _pty_launcher(binary, args, files, answers, str(tmp_path / "c.bin"),
                      env)
    p = _pty_launcher(PY_LAUNCHER, args, files, answers,
                      str(tmp_path / "p.bin"), env)
    assert c == p
    assert c[1]


@pytest.mark.parametrize("term", sorted(_TERMS))
def test_auto_sieve_matches_python(binary, cpu_env, corpus, term, tmp_path):
    """No -p: both launchers run the CSI >q / DA1 sieve against the same
    scripted terminal (and the OSC 11 background query for the alpha
    image) and write the same bytes."""
    _pty_both(binary, ["--debug-no-frame-delay", "-g30x15"],
              [corpus["alpha_80x100.png"]], _TERMS[term], tmp_path, cpu_env)


# ---------------------------------------------------------------------
# The sources and the routes
# ---------------------------------------------------------------------

def test_sources_need_no_deflate_or_jax_headers():
    """The port's C sources include neither libdeflate.h nor zlib.h, nor
    anything of the JAX package, and the launcher execs the port's
    launcher."""
    srcs = ("timg_fast_main.cc", "timg_still.cc", "timg_native.cc",
            "css3_colors.inc")
    for name in srcs:
        with open(os.path.join(NATIVE, name)) as f:
            text = f.read()
        includes = re.findall(r"^\s*#\s*include\s*[<\"]([^>\"]+)", text,
                              re.M)
        assert not {"libdeflate.h", "zlib.h"} & set(includes), name
        assert not [i for i in includes if "timg_tpu/" in i], name
    with open(os.path.join(NATIVE, "timg_fast_main.cc")) as f:
        text = f.read()
    assert '"/timg-tpu-torch"' in text and '"/timg-tpu"' not in text


def test_css3_table_in_sync():
    """css3_colors.inc holds the port's Python colour table, entry for
    entry."""
    from timg_tpu_torch._css3_colors import CSS3_COLORS

    with open(os.path.join(NATIVE, "css3_colors.inc")) as f:
        rows = re.findall(r'\{"([a-z]+)", (\d+), (\d+), (\d+)\}', f.read())
    want = [(name, *(str(int(CSS3_COLORS[name][i:i + 2], 16))
                     for i in (1, 3, 5))) for name in sorted(CSS3_COLORS)]
    assert rows == want


class _Listener:
    """A socket at ``path`` that counts connections and the bytes each
    sent; with ``handle``, each connection is passed to it instead."""

    def __init__(self, path, handle=None):
        self.path = path
        self.connections = 0
        self.received = 0
        self._handle = handle
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._srv.bind(path)
        self._srv.listen(4)
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            self.connections += 1
            with conn:
                if self._handle is not None:
                    self._handle(conn)
                    continue
                conn.settimeout(5)
                try:
                    while True:
                        data = conn.recv(4096)
                        if not data:
                            break
                        self.received += len(data)
                except OSError:
                    pass

    def close(self):
        self._srv.close()


_ONE_REQUEST = """
import os, socket, sys
sys.path.insert(0, {repo!r})
from timg_tpu_torch import serve
srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
srv.bind({sock!r})
srv.listen(1)
print("listening", flush=True)
conn, _ = srv.accept()
serve._handle(conn, serve._identity(os.environ))
conn.close()
print("served", flush=True)
"""


def test_default_device_is_served_never_rendered_on_host(binary, corpus,
                                                         tmp_path):
    """Without the CPU asked the binary renders nothing on the host: it
    hands the invocation to the server (a process running the port's
    serve handler for the default device, for one request) and the
    served triple equals the cold run's.  With no card here both end in
    the CLI's 'CUDA is not available', exit 2, no output; on the card
    the served run reaches the kernels (chip_smoke's fastpath phase)."""
    sock = str(tmp_path / "d.sock")
    env = dict(_BASE_ENV, TIMG_TPU_SERVE_SOCKET=sock)
    server = subprocess.Popen(
        [sys.executable, "-c", _ONE_REQUEST.format(repo=REPO, sock=sock)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        assert server.stdout.readline() == b"listening\n"
        args = ["-pq", "-g40x20", "-b", "black"]
        img = [corpus["noise_64x48.png"]]
        served = _run(binary, args, img, str(tmp_path / "s.out"), env)
        assert server.stdout.readline() == b"served\n"
    finally:
        if server.poll() is None:
            server.kill()
        server.wait()
    cold = _run(binary, args, img, str(tmp_path / "c.out"),
                dict(env, TIMG_TPU_NO_SERVE="1"))
    assert served == cold
    import torch
    if not torch.cuda.is_available():
        assert served[:2] == (2, b"")
        assert b"CUDA is not available" in served[2]


def test_cpu_still_never_connects(binary, corpus, tmp_path):
    """With the CPU asked, an in-envelope still is rendered by the binary
    itself: the socket sees no connection."""
    sock = str(tmp_path / "n.sock")
    listener = _Listener(sock)
    env = dict(_BASE_ENV, TIMG_TPU_SERVE_SOCKET=sock,
               TIMG_TPU_TORCH_DEVICE="cpu")
    try:
        rc, out, err = _run(binary, ["-pq", "-g40x20", "-b", "black"],
                            [corpus["noise_64x48.png"]],
                            str(tmp_path / "n.out"), env)
    finally:
        listener.close()
    assert (rc, err) == (0, b"") and out
    assert listener.connections == 0


_FOREIGN_LISTENER = """
import os, socket
srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
srv.bind({path!r})
os.setgid(65534)
os.setuid(65534)
srv.listen(1)
print("listening", flush=True)
srv.settimeout(60)
got = 0
try:
    conn, _ = srv.accept()
    conn.settimeout(5)
    while True:
        data = conn.recv(4096)
        if not data:
            break
        got += len(data)
except OSError:
    pass
print(got, flush=True)
"""


def _foreign_listener(path):
    """A process listening at ``path`` as another uid: it binds as this
    uid (so the socket file is this uid's) and listens after setuid, so
    only SO_PEERCRED, which reports the listener's credentials at
    listen(), tells it apart.  It prints the bytes it received."""
    proc = subprocess.Popen([sys.executable, "-c",
                             _FOREIGN_LISTENER.format(path=path)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    return proc, proc.stdout.readline() == b"listening\n"


def test_foreign_sockets_are_never_sent_a_byte(binary, corpus, tmp_path):
    """A socket another uid owns, a listener of another uid behind a
    socket this uid owns, and a path that is not a socket: the binary
    sends none of them a byte and runs as with no server (here: the
    CLI's 'CUDA is not available' through the python launcher, which
    refuses them too).  `--help` keeps each run off torch."""
    args, img = ["--help"], []
    base_env = dict(_BASE_ENV)
    base_env.pop("TIMG_TPU_TORCH_DEVICE", None)
    want = _run(binary, args, img, str(tmp_path / "w.out"),
                dict(base_env, TIMG_TPU_NO_SERVE="1"))
    assert want[0] == 0

    owned = str(tmp_path / "owned.sock")
    listener = _Listener(owned)
    os.chown(owned, 65534, 65534)
    try:
        got = _run(binary, args, img, str(tmp_path / "o.out"),
                   dict(base_env, TIMG_TPU_SERVE_SOCKET=owned))
    finally:
        listener.close()
    assert listener.connections == 0 and got == want

    plain = tmp_path / "plain"
    plain.write_bytes(b"")
    got = _run(binary, args, img, str(tmp_path / "p.out"),
               dict(base_env, TIMG_TPU_SERVE_SOCKET=str(plain)))
    assert got == want and plain.read_bytes() == b""

    path = str(tmp_path / "f.sock")
    proc, ok = _foreign_listener(path)
    assert ok, proc.stderr.read().decode()[-400:]
    try:
        got = _run(binary, args, img, str(tmp_path / "f.out"),
                   dict(base_env, TIMG_TPU_SERVE_SOCKET=path))
    finally:
        # wake the child's accept (a connection of our own that sends
        # nothing) so it reports and exits
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            c.connect(path)
        except OSError:
            pass
        c.close()
        received = proc.communicate(timeout=60)[0]
    assert got == want
    assert received == b"0\n"
