"""A small host-level RPC: the control plane's transport.

Port of ``dss_ml_at_scale_tpu/runtime/rpc.py``. The reference's control
plane is Spark's RPC between its coordinator and executors, which ships
trial objectives to the executors (``SparkTrials``). The data plane of the port is
``torch.distributed`` inside programs; this module is the small host-side
complement for work that is no such program: handing HPO trials to worker
processes and hosts.

Wire: an 8-byte big-endian length prefix and a pickled request or response
dict, one request per connection. Pickle runs code on receipt, so the
transport authenticates peers before it unpickles anything: with a
``secret`` both sides run a mutual HMAC-SHA256 challenge over raw
length-prefixed frames first. A loopback bind may go without a secret;
binding any other interface without one raises unless
``allow_insecure=True``.

Request ``{"method": str, "payload": Any}``; response ``{"ok": True,
"value": Any}`` or ``{"ok": False, "error": str (the traceback)}``.
"""

from __future__ import annotations

import hmac
import os
import pickle
import socket
import socketserver
import struct
import threading
import traceback
from typing import Any, Callable, Mapping

_LEN = struct.Struct(">Q")
_MAX_MESSAGE = 1 << 31  # a 2 GiB bound on one message

_CHALLENGE = b"#DSST_CHALLENGE#"
_WELCOME = b"#DSST_WELCOME#"
_FAILURE = b"#DSST_FAILURE#"
_NONCE_BYTES = 32
_MAX_HANDSHAKE = 128  # handshake frames are tiny; bound them hard

# "" is not loopback: socketserver binds ("", port) to INADDR_ANY.
_LOOPBACK_HOSTS = ("127.0.0.1", "localhost", "::1")
# How often the accept loop looks for shutdown(): what a shutdown waits at most.
_POLL_S = 0.05


class RpcAuthError(ConnectionError):
    """The HMAC challenge failed (a wrong or missing shared secret)."""


class RpcHandshakeTimeout(RpcAuthError):
    """The handshake stalled: a hung peer, or one that speaks no auth.

    Unlike a rejected digest (provably the wrong secret), a stall may be a
    wedged host: a worker pool treats it as a transport failure (drop and
    probe), not as a misconfiguration.
    """


class RpcConnectTimeout(ConnectionError):
    """The TCP connect timed out before any request was delivered.

    Not a ``TimeoutError``: a timeout after the connect means the peer may
    still be computing the abandoned request (cool down before re-admitting
    it), while a connect timeout delivered nothing (probe again at once).
    """


class RpcRemoteError(RuntimeError):
    """The remote handler raised; the message carries its traceback."""


def _send_msg(sock: socket.socket, obj: Any) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> Any:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > _MAX_MESSAGE:
        raise ValueError(f"message of {n} bytes exceeds bound {_MAX_MESSAGE}")
    return pickle.loads(_recv_exact(sock, n))


# -- the handshake: raw frames only, no pickle before it ---------------------

def _send_raw(sock: socket.socket, data: bytes) -> None:
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_raw(sock: socket.socket, max_len: int = _MAX_HANDSHAKE) -> bytes:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > max_len:
        raise RpcAuthError(f"handshake frame of {n} bytes exceeds {max_len}")
    return _recv_exact(sock, n)


def _normalize_secret(secret: bytes | str | None) -> bytes | None:
    if secret is None:
        return None
    key = secret.encode() if isinstance(secret, str) else bytes(secret)
    if not key:
        # An empty key would pass the bind guard and authenticate nothing.
        raise ValueError("RPC secret must be non-empty (or None)")
    return key


def _deliver_challenge(sock: socket.socket, secret: bytes) -> None:
    nonce = os.urandom(_NONCE_BYTES)
    _send_raw(sock, _CHALLENGE + nonce)
    digest = _recv_raw(sock)
    if not hmac.compare_digest(digest, hmac.new(secret, nonce, "sha256").digest()):
        _send_raw(sock, _FAILURE)
        raise RpcAuthError("peer failed HMAC challenge (wrong secret)")
    _send_raw(sock, _WELCOME)


def _answer_challenge(sock: socket.socket, secret: bytes) -> None:
    msg = _recv_raw(sock)
    if not msg.startswith(_CHALLENGE):
        raise RpcAuthError("peer did not send an HMAC challenge")
    _send_raw(sock, hmac.new(secret, msg[len(_CHALLENGE):], "sha256").digest())
    if _recv_raw(sock) != _WELCOME:
        raise RpcAuthError("peer rejected our HMAC digest (wrong secret)")


class RpcServer:
    """A threaded TCP server that dispatches to named handlers.

    ``RpcServer({"evaluate": fn}, port=0)`` binds a port the OS picks, read
    back from ``.address``. ``serve_background()`` runs the accept loop on a
    daemon thread; ``serve_forever()`` blocks (the CLI's worker process).
    Handler threads share nothing mutable on this object.
    """

    def __init__(self, handlers: Mapping[str, Callable[[Any], Any]], host: str = "127.0.0.1",
                 port: int = 0, recv_timeout: float = 60.0, secret: bytes | str | None = None,
                 allow_insecure: bool = False):
        self.handlers = dict(handlers)
        self.recv_timeout = recv_timeout
        self.secret = _normalize_secret(secret)
        if self.secret is None and not allow_insecure and host not in _LOOPBACK_HOSTS:
            raise ValueError(
                f"refusing to bind {host!r} without a shared secret: the RPC wire executes "
                "pickle on receipt. Pass secret=..., or allow_insecure=True on a trusted "
                "isolated network.")
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):  # one request per connection
                # Bound the receive: a probe that connects and never sends a
                # whole message must not pin a handler thread. The handler
                # and the response may then take as long as the work needs.
                self.request.settimeout(outer.recv_timeout)
                try:
                    if outer.secret is not None:
                        # Authenticate before unpickling; mutual, so the
                        # client checks us before trusting a response.
                        _deliver_challenge(self.request, outer.secret)
                        _answer_challenge(self.request, outer.secret)
                    req = _recv_msg(self.request)
                except (ConnectionError, EOFError, ValueError, TimeoutError, OSError):
                    return
                self.request.settimeout(None)
                try:
                    fn = outer.handlers[req["method"]]
                    resp = {"ok": True, "value": fn(req.get("payload"))}
                except Exception:
                    resp = {"ok": False, "error": traceback.format_exc()}
                try:
                    _send_msg(self.request, resp)
                except ConnectionError:
                    pass

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)
        self._serving = False
        self.address: tuple[str, int] = self._server.server_address[:2]

    def serve_background(self) -> "RpcServer":
        self._serving = True
        threading.Thread(target=self._server.serve_forever, args=(_POLL_S,), daemon=True).start()
        return self

    def serve_forever(self) -> None:
        self._serving = True
        self._server.serve_forever(_POLL_S)

    def shutdown(self) -> None:
        # socketserver's shutdown() waits for a flag only serve_forever sets:
        # on a server never served it would block, so only close the socket.
        if self._serving:
            self._server.shutdown()
        self._server.server_close()


def rpc_call(address: tuple[str, int] | str, method: str, payload: Any = None,
             timeout: float | None = 600.0, secret: bytes | str | None = None, retry=None):
    """One call: connect, send, wait for the response, raise on a remote error.

    With ``secret`` set, answers the server's HMAC challenge and issues its
    own before anything is unpickled. ``retry`` (a
    :class:`~dss_ml_at_scale_tpu_torch.resilience.retry.RetryPolicy`)
    retries transport failures (a dead peer, a timeout, a truncated stream)
    with jittered backoff; remote-handler and auth errors are never retried.
    Each attempt passes the ``rpc.send.<method>`` fault site.
    """
    from ..resilience.faults import maybe_fail

    if isinstance(address, str):
        host, _, port = address.rpartition(":")
        address = (host or "127.0.0.1", int(port))
    key = _normalize_secret(secret)

    def _attempt() -> Any:
        maybe_fail(f"rpc.send.{method}")
        try:
            sock = socket.create_connection(address, timeout=timeout)
        except (TimeoutError, socket.timeout) as e:
            raise RpcConnectTimeout(f"connect to {address} timed out after {timeout}s") from e
        with sock:
            if key is not None:
                # A server without a secret never sends the challenge: bound
                # that wait tightly and name the cause, so a secret mismatch
                # fails in seconds as an auth error.
                sock.settimeout(min(10.0, timeout) if timeout else 10.0)
                try:
                    _answer_challenge(sock, key)
                    _deliver_challenge(sock, key)
                except (TimeoutError, socket.timeout) as e:
                    raise RpcHandshakeTimeout(
                        f"handshake with {address} timed out: the peer likely has no secret "
                        "configured (or another protocol), or is hung") from e
                sock.settimeout(timeout)
            _send_msg(sock, {"method": method, "payload": payload})
            return _recv_msg(sock)

    if retry is None:
        resp = _attempt()
    else:
        from ..resilience.retry import call_with_retry

        resp = call_with_retry(_attempt, policy=retry, site=f"rpc.send.{method}")
    if not resp["ok"]:
        raise RpcRemoteError(resp["error"])
    return resp["value"]
