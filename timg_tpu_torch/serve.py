"""Resident session mode: ``timg-tpu-torch --serve`` (counterpart of
timg_tpu/serve.py).

A one-shot run of the port pays seconds of process start (the torch
import and the CUDA context) before its milliseconds of work.  Serve
mode keeps ONE warm process resident: a unix-socket server holding the
imported torch session, the CUDA context, the loaded kernel library and
native helper and the tap and table caches, so a repeat invocation
costs a socket round trip plus the work.

Protocol (one request per connection, requests served in turn; the JAX
package's, byte for byte):

  client -> server   1 byte  b"F"  + SCM_RIGHTS [stdin, stdout, stderr]
  client -> server   one JSON line {"argv": [...], "cwd": "...",
                                    "env": {...}}
  client -> server   b"I\\n" at any time = forward SIGINT
  server -> client   b"R <exitcode>\\n"   on completion
  server -> client   b"D\\n"             = delegate (run it yourself)

Passing the client's real fds makes terminal queries, pagers and the
escape stream behave exactly as a direct run: the served process IS on
the client's tty for the request.  Requests the resident session must
not run are delegated: a TIMG_TPU_TORCH_DEVICE, CUDA_VISIBLE_DEVICES or
CUDA_DEVICE_ORDER other than the server's (the process computes on one
device type, on the cards CUDA showed it at start) and a nested --serve.

The port's launcher (``timg-tpu-torch``) connects whenever the socket
exists, before it imports torch (``try_serve``).  The socket is the
port's own, so neither package's client reaches the other's server:
$XDG_RUNTIME_DIR/timg-tpu-torch.sock, else
/tmp/timg-tpu-torch-<uid>.sock; TIMG_TPU_SERVE_SOCKET overrides the
path and TIMG_TPU_NO_SERVE=1 turns the client off.  The request carries
the client's environment and terminal, so both ends hold to one user:
the server creates its socket 0600 and serves only peers of its own uid
(SO_PEERCRED), and a client connects only to a socket that its user
owns, with a listener of its own uid; anything else runs cold.

This module imports only the standard library at module level, so a
client loads it without torch.
"""

from __future__ import annotations

import array
import json
import os
import signal
import socket
import stat
import struct
import sys
import threading
from typing import List, Optional

_MAX_REQ = 1 << 20  # sanity bound on the JSON request line
_DEVICE_ENV = "TIMG_TPU_TORCH_DEVICE"
# What picks the process's cards: CUDA reads these once, at its first
# call, so a request that sets them otherwise cannot be served here.
_CARD_ENV = ("CUDA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER")


def _device_name(env) -> str:
    """The device type a process with ``env`` computes on (ops/backend.py
    reads the same variable)."""
    return env.get(_DEVICE_ENV, "cuda").strip().lower() or "cuda"


def _identity(env) -> tuple:
    """What fixes the device a process computes on for its whole life:
    the device type and the cards CUDA was shown."""
    return (_device_name(env),) + tuple(env.get(k) for k in _CARD_ENV)


def _ours(path: str) -> bool:
    """A socket that this user owns.  Anything else at the path (a file,
    or another user's listener in a shared /tmp) never sees a request:
    it would receive the environment and the terminal."""
    try:
        st = os.lstat(path)
    except OSError:
        return False
    return stat.S_ISSOCK(st.st_mode) and st.st_uid == os.getuid()


def _peer_uid(conn: socket.socket) -> Optional[int]:
    """The uid of the process at the other end (SO_PEERCRED), or None
    where it cannot be read."""
    try:
        creds = conn.getsockopt(socket.SOL_SOCKET, socket.SO_PEERCRED,
                                struct.calcsize("3i"))
    except (AttributeError, OSError):
        return None
    return struct.unpack("3i", creds)[1]


def default_socket_path() -> str:
    override = os.environ.get("TIMG_TPU_SERVE_SOCKET")
    if override:
        return override
    run_dir = os.environ.get("XDG_RUNTIME_DIR")
    if run_dir and os.path.isdir(run_dir):
        return os.path.join(run_dir, "timg-tpu-torch.sock")
    return os.path.join("/tmp", f"timg-tpu-torch-{os.getuid()}.sock")


def _recv_fds(conn: socket.socket, n_fds: int = 3):
    """Receive the b'F' hello + n_fds rights."""
    fds = array.array("i")
    msg, ancdata, _flags, _addr = conn.recvmsg(
        1, socket.CMSG_LEN(n_fds * fds.itemsize))
    if msg != b"F":
        return None
    for cmsg_level, cmsg_type, cmsg_data in ancdata:
        if (cmsg_level == socket.SOL_SOCKET
                and cmsg_type == socket.SCM_RIGHTS):
            fds.frombytes(
                cmsg_data[:len(cmsg_data) - len(cmsg_data) % fds.itemsize])
    if len(fds) != n_fds:
        for fd in fds:
            os.close(fd)
        return None
    return list(fds)


def _send_fds(conn: socket.socket, fds: List[int]) -> None:
    conn.sendmsg([b"F"], [(socket.SOL_SOCKET, socket.SCM_RIGHTS,
                           array.array("i", fds))])


def _read_line(conn: socket.socket, limit: int = _MAX_REQ) -> bytes:
    buf = bytearray()
    while len(buf) < limit:
        ch = conn.recv(1)
        if not ch:
            return bytes(buf)
        if ch == b"\n":
            return bytes(buf)
        buf += ch
    return bytes(buf)


def _servable(argv: List[str], env: dict, identity: tuple) -> bool:
    """Not a nested --serve, and for the server's ``identity``: the
    resident process holds one device type (a CUDA context, or none) on
    the cards it was started with."""
    if any(a == "--serve" or a.startswith("--serve=") for a in argv):
        return False
    return _identity(env) == identity


class _RequestGuard:
    """Swap process identity (fds 0-2, cwd, environ) to the client's
    for the duration of one request, restoring afterwards."""

    def __init__(self, fds: List[int], cwd: str, env: dict):
        self._fds = fds
        self._cwd = cwd
        self._env = env
        self._saved_fds: List[int] = []
        self._saved_cwd = ""
        self._saved_env: dict = {}
        self._saved_flags = None

    def __enter__(self):
        import fcntl

        self._saved_fds = [os.dup(i) for i in range(3)]
        for i, fd in enumerate(self._fds):
            os.dup2(fd, i)
        # Non-blocking stdout for the request: a wedged client (tty
        # never drained) must not block the resident process forever --
        # the sequencer's write loop handles EAGAIN and the watchdog's
        # interrupt flag.  Flags live on the shared open file
        # description, so they are restored on exit (the client still
        # owns the terminal afterwards).
        try:
            self._saved_flags = fcntl.fcntl(1, fcntl.F_GETFL)
            fcntl.fcntl(1, fcntl.F_SETFL,
                        self._saved_flags | os.O_NONBLOCK)
        except OSError:
            self._saved_flags = None
        self._saved_cwd = os.getcwd()
        try:
            os.chdir(self._cwd)
        except OSError:
            pass
        self._saved_env = dict(os.environ)
        os.environ.clear()
        os.environ.update(self._env)
        return self

    def __exit__(self, *exc):
        import fcntl

        try:
            sys.stdout.flush()
            sys.stderr.flush()
        except Exception:
            pass
        if self._saved_flags is not None:
            try:
                fcntl.fcntl(1, fcntl.F_SETFL, self._saved_flags)
            except OSError:
                pass
        for i, fd in enumerate(self._saved_fds):
            os.dup2(fd, i)
            os.close(fd)
        for fd in self._fds:
            try:
                os.close(fd)
            except OSError:
                pass
        os.environ.clear()
        os.environ.update(self._saved_env)
        try:
            os.chdir(self._saved_cwd)
        except OSError:
            pass
        return False


def _watch_interrupt(conn: socket.socket, done: threading.Event) -> None:
    """Socket-side interrupt: b'I' lines (or client death) set the same
    flag the CLI's SIGINT handler sets (ref timg.cc:156-157 analog)."""
    from timg_tpu_torch import cli

    try:
        conn.settimeout(0.25)
        while not done.is_set():
            try:
                data = conn.recv(1)
            except socket.timeout:
                continue
            except OSError:
                break
            if done.is_set():   # request already finished: ignore
                break
            if not data:        # client vanished: stop producing output
                cli.interrupt_received = True
                break
            if data == b"I":
                cli.interrupt_received = True
    finally:
        try:
            conn.settimeout(None)
        except OSError:
            pass


def _end_request() -> None:
    """Drop what a request leaves on the device: the plane caches'
    frames hold their windows' device words."""
    from timg_tpu_torch.render import plane_cache

    plane_cache.BLOCK_PLANES.clear()
    plane_cache.SIXEL_PLANES.clear()


def _handle(conn: socket.socket, identity: tuple) -> None:
    from timg_tpu_torch import cli

    fds = _recv_fds(conn)
    if fds is None:
        return
    try:
        line = _read_line(conn)
        req = json.loads(line.decode("utf-8"))
        argv = [str(a) for a in req.get("argv", [])]
        cwd = str(req.get("cwd", "/"))
        env = {str(k): str(v) for k, v in req.get("env", {}).items()}
    except Exception:
        for fd in fds:
            os.close(fd)
        return
    if not _servable(argv, env, identity):
        for fd in fds:
            os.close(fd)
        try:
            conn.sendall(b"D\n")
        except OSError:
            pass
        return
    done = threading.Event()
    watcher = threading.Thread(target=_watch_interrupt,
                               args=(conn, done), daemon=True)
    watcher.start()

    # Per-request watchdog: a request that outlives the budget gets the
    # interrupt flag -- with the non-blocking client stdout this
    # unwedges blocked writes, so one stuck client cannot starve every
    # later invocation.  cli.main resets the flag at entry, so a
    # watchdog firing at the done/next-request boundary cannot poison
    # the following request.
    try:
        budget = float(os.environ.get("TIMG_TPU_SERVE_REQUEST_TIMEOUT",
                                      "300"))
    except ValueError:
        budget = 300.0

    def _watchdog():
        if not done.wait(budget):
            cli.interrupt_received = True

    if budget > 0:
        threading.Thread(target=_watchdog, daemon=True).start()
    code = 1
    try:
        with _RequestGuard(fds, cwd, env):
            try:
                code = cli.main(argv)
            except SystemExit as e:
                code = int(e.code or 0)
            except BrokenPipeError:
                code = 1
            except Exception:
                import traceback
                traceback.print_exc(file=sys.stderr)
                code = 1
    finally:
        done.set()
        _end_request()
        # The watcher is not joined: its poll slice would add up to
        # 0.25 s to every request.  It is a daemon thread that exits on
        # its next timeout tick (or when the connection closes) and
        # checks ``done`` before touching the interrupt flag.
    try:
        conn.sendall(b"R %d\n" % code)
    except OSError:
        pass


def warm_up() -> None:
    """What the first request would otherwise pay: the device (a CUDA
    context on ``cuda``), the kernel library (built if stale), the
    native helper, and the modules a request imports (the CLI, the
    sources, the canvases, the device windows).  Raises RuntimeError
    when the device cannot be opened: a server asked for ``cuda`` never
    serves on the CPU."""
    import torch

    import timg_tpu_torch.cli  # noqa: F401
    import timg_tpu_torch.render.ansi  # noqa: F401
    import timg_tpu_torch.render.iterm2  # noqa: F401
    import timg_tpu_torch.render.kitty  # noqa: F401
    import timg_tpu_torch.render.renderer  # noqa: F401
    import timg_tpu_torch.render.sixel_render  # noqa: F401
    import timg_tpu_torch.sources.base  # noqa: F401
    import timg_tpu_torch.sources.pil_source  # noqa: F401
    import timg_tpu_torch.sources.video_source  # noqa: F401
    from timg_tpu_torch.native import runtime
    from timg_tpu_torch.ops import _build, backend

    dev = backend.device()
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
        _build.load()
    runtime.load()
    runtime.load_video()


class _Stop(Exception):
    """SIGTERM or SIGINT to the server: leave the accept loop."""


def _stop(signo, frame):  # noqa: ARG001
    raise _Stop()


def _arm_server_signals() -> None:
    # a served request arms the CLI's handlers and then restores the
    # defaults (cli._arm_signals), so the server re-arms its own after
    # each one; off the main thread (tests) there are none to arm
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _stop)
        signal.signal(signal.SIGINT, _stop)


def serve(socket_path: Optional[str] = None,
          ready_callback=None, max_requests: Optional[int] = None) -> int:
    """Run the resident server (blocks) until SIGTERM or SIGINT, which
    remove the socket.  ``max_requests`` bounds the loop for tests;
    ``ready_callback`` fires once listening and warm.  Returns 2 when the
    device cannot be opened."""
    path = socket_path or default_socket_path()
    if os.path.lexists(path) and not _ours(path):
        print(f"timg-tpu-torch --serve: {path} is not this user's socket",
              file=sys.stderr)
        return 1
    # stale socket from a dead server: connect() failing means unused
    if os.path.exists(path):
        probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            probe.connect(path)
            print(f"timg-tpu-torch --serve: {path} already served",
                  file=sys.stderr)
            return 1
        except OSError:
            os.unlink(path)
        finally:
            probe.close()
    try:
        warm_up()
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 2
    identity = _identity(os.environ)
    uid = os.getuid()
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        # created 0600: no other user may connect, not even between the
        # bind and a later chmod
        umask = os.umask(0o177)
        try:
            srv.bind(path)
        finally:
            os.umask(umask)
        srv.listen(8)
        _arm_server_signals()
        if ready_callback is not None:
            ready_callback()
        served = 0
        while max_requests is None or served < max_requests:
            try:
                conn, _ = srv.accept()
            except OSError:
                break
            try:
                if _peer_uid(conn) == uid:
                    _handle(conn, identity)
            finally:
                try:
                    conn.close()
                except OSError:
                    pass
                _arm_server_signals()
            served += 1
        return 0
    except _Stop:
        return 0
    finally:
        srv.close()
        try:
            os.unlink(path)
        except OSError:
            pass


def _connect(argv: List[str], path: str,
             env: Optional[dict] = None) -> Optional[socket.socket]:
    """Connect and send the request with OUR stdio (fds 0-2); the
    connection, or None when no server listens, the socket or its
    listener is another user's, or the request did not fully arrive
    (safe to run it here instead)."""
    if not _ours(path):
        return None
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        conn.settimeout(5.0)
        conn.connect(path)
        if _peer_uid(conn) != os.getuid():
            conn.close()
            return None
        _send_fds(conn, [0, 1, 2])
        req = {"argv": argv, "cwd": os.getcwd(),
               "env": dict(os.environ if env is None else env)}
        conn.sendall(json.dumps(req).encode("utf-8") + b"\n")
        return conn
    except OSError:
        conn.close()
        return None


def request(argv: List[str], socket_path: Optional[str] = None,
            timeout: float = 600.0) -> Optional[int]:
    """Python client: run ``argv`` on the resident server with OUR
    stdio.  Returns the exit code, or None when the server is absent
    or answered 'delegate' (the caller runs the one-shot path)."""
    conn = _connect(argv, socket_path or default_socket_path())
    if conn is None:
        return None
    try:
        conn.settimeout(timeout)
        line = _read_line(conn, 64)
        if line.startswith(b"R "):
            return int(line[2:])
        return None
    except OSError:
        return None
    finally:
        conn.close()


def try_serve(argv: List[str]) -> Optional[int]:
    """The launcher's client (timg_tpu/native/timg_fast_main.cc
    ``try_serve``): when the socket exists, send the invocation and
    return the served exit code.  None -- the launcher then runs the CLI
    itself -- only when no server listens (absent or stale socket) or
    the server answered 'delegate', both before any output; once the
    request is in flight SIGINT and SIGTERM are forwarded as b"I", and
    a connection lost mid-request returns 1 (the output's state is
    unknown, so the run is not repeated)."""
    path = default_socket_path()
    if not os.path.exists(path):
        return None
    conn = _connect(argv, path)
    if conn is None:
        return None

    def forward(signo, frame):  # noqa: ARG001
        try:
            conn.send(b"I\n")
        except OSError:
            pass

    saved = [(s, signal.signal(s, forward))
             for s in (signal.SIGINT, signal.SIGTERM)]
    try:
        conn.settimeout(None)
        line = _read_line(conn, 64)
    except OSError:
        line = b""
    finally:
        for s, handler in saved:
            signal.signal(s, handler)
        conn.close()
    if line == b"D":
        return None
    if line.startswith(b"R "):
        return int(line[2:])
    return 1
