"""HTTP client for the snsd gateways + collector registration
(``deeprest_tpu/loadgen/client.py``: the same requests and frames).

Speaks the same REST surface the reference's locust tasks hit (reference:
locust/locustfile-normal.py:88-144 → nginx-web-server/conf/nginx.conf
routes), over persistent keep-alive connections.
"""

from __future__ import annotations

import http.client
import json
import socket
import struct
import urllib.parse


class GatewayClient:
    """One persistent connection to a gateway; reconnects transparently."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.host, self.port, self.timeout = host, port, timeout
        self._conn: http.client.HTTPConnection | None = None

    # -- plumbing -------------------------------------------------------

    def _request(self, method: str, path: str, params: dict | None = None,
                 body: bytes | None = None, content_type: str | None = None):
        if params and method == "GET":
            path = path + "?" + urllib.parse.urlencode(params)
            payload, ctype = None, None
        elif params:
            payload = urllib.parse.urlencode(params).encode()
            ctype = "application/x-www-form-urlencoded"
        else:
            payload, ctype = body, content_type
        headers = {"Content-Type": ctype} if ctype else {}
        for attempt in (0, 1):
            if self._conn is None:
                self._conn = http.client.HTTPConnection(
                    self.host, self.port, timeout=self.timeout)
            try:
                self._conn.request(method, path, body=payload, headers=headers)
                resp = self._conn.getresponse()
                data = resp.read()
                if resp.status >= 400:
                    raise RuntimeError(
                        f"{method} {path} -> {resp.status}: {data[:200]!r}")
                return json.loads(data) if data else None
            except (http.client.HTTPException, OSError):
                self.close()
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def healthz(self) -> bool:
        try:
            self._request("GET", "/healthz")
            return True
        except Exception:
            return False

    # -- API surface (reference routes, nginx.conf:82-339) --------------

    def register(self, user_id: int, username: str, password: str):
        return self._request("POST", "/wrk2-api/user/register",
                             {"user_id": user_id, "username": username,
                              "password": password})

    def follow(self, user_id: int, followee_id: int):
        return self._request("POST", "/wrk2-api/user/follow",
                             {"user_id": user_id, "followee_id": followee_id})

    def unfollow(self, user_id: int, followee_id: int):
        return self._request("POST", "/wrk2-api/user/unfollow",
                             {"user_id": user_id, "followee_id": followee_id})

    def login(self, username: str, password: str):
        return self._request("POST", "/wrk2-api/user/login",
                             {"username": username, "password": password})

    def compose(self, user_id: int, username: str, text: str,
                media_id: str | None = None, media_type: str = "jpg"):
        params = {"user_id": user_id, "username": username, "text": text}
        if media_id is not None:
            params["media_id"] = media_id
            params["media_type"] = media_type
        return self._request("POST", "/wrk2-api/post/compose", params)

    def read_home_timeline(self, user_id: int, start: int = 0, stop: int = 9):
        return self._request("GET", "/wrk2-api/home-timeline/read",
                             {"user_id": user_id, "start": start, "stop": stop})

    def read_user_timeline(self, user_id: int, start: int = 0, stop: int = 9):
        return self._request("GET", "/wrk2-api/user-timeline/read",
                             {"user_id": user_id, "start": start, "stop": stop})

    # -- media frontend (reference: upload-media.lua) --------------------

    def upload_media(self, payload: bytes, media_type: str = "jpg"):
        return self._request(
            "POST", f"/upload-media?media_type={media_type}",
            body=payload, content_type="application/octet-stream")

    def get_media(self, media_id: str):
        return self._request("GET", "/get-media", {"media_id": media_id})


def register_with_collector(host: str, port: int, component: str, pid: int,
                            timeout: float = 2.0) -> None:
    """Register ``pid`` under ``component`` in the collector's metric
    sampler — 4-byte big-endian length-prefixed JSON frame (native/sns
    framing; the cryptojack burner uses this to attribute its CPU to a
    victim component the way the reference's pow.py rides inside a pod)."""
    payload = json.dumps({"register": component, "pid": pid}).encode()
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(struct.pack(">I", len(payload)) + payload)


def chaos_burn(host: str, port: int, seconds: float,
               timeout: float = 5.0) -> dict:
    """Fire the ChaosBurn fault injection at a service's RPC port: the
    service forks an UNREGISTERED cpu-burning child (simulated compromise;
    requires the cluster to run with DEEPREST_CHAOS=1).  Returns the
    injected child's pid — the collector must attribute its CPU to the
    victim with no cooperation from either."""
    req = json.dumps({"m": "ChaosBurn", "t": [0, 0, False],
                      "a": {"seconds": seconds}}).encode()
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(struct.pack(">I", len(req)) + req)
        hdr = _recv_exact(s, 4)
        (length,) = struct.unpack(">I", hdr)
        resp = json.loads(_recv_exact(s, length))
    if not resp.get("ok", False):
        raise RuntimeError(f"ChaosBurn failed: {resp.get('e')}")
    return resp.get("r", {})


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("socket closed mid-frame")
        buf += chunk
    return buf
