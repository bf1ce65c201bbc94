"""The endpoint plane: node identity and dial-side endpoint choice.

Every component that used to hardcode ``127.0.0.1`` or a unix socket
path asks this module instead:

* ``node_ip()`` — the address this node ADVERTISES (``RTT_NODE_IP``,
  else the resolved hostname when it isn't loopback, else 127.0.0.1).
* ``pick(unix, tcp)`` — the address a CLIENT dials given a peer's
  advertised pair: the unix path for on-box peers (cheapest), the
  ``host:port`` otherwise.
* ``partitioned(peer_host)`` — the ``net.partition`` chaos gate: true
  while a fault spec severs the ``node_ip()>peer_host`` direction.
"""

from __future__ import annotations

import os
import socket
import threading

_NODE_IP = None
_NODE_IP_LOCK = threading.Lock()


def enabled() -> bool:
    """Master gate for the netx plane (TCP endpoint advertisement and
    the off-box fast paths). Default ON; ``RTT_NETX=0`` restores the
    unix-only seed behaviour."""
    return os.environ.get("RTT_NETX", "1").lower() not in (
        "0", "false", "no")


def force_tcp() -> bool:
    """``RTT_NET_FORCE_TCP=1``: treat every peer as off-box so the
    simulated multi-"host" harness exercises the TCP lanes on one
    machine."""
    return os.environ.get("RTT_NET_FORCE_TCP", "").lower() in (
        "1", "true", "yes")


def node_ip() -> str:
    """The IP this node binds and advertises. Cached per process —
    RTT_NODE_IP is read once, like the rest of the node identity."""
    global _NODE_IP
    ip = _NODE_IP
    if ip is None:
        with _NODE_IP_LOCK:
            if _NODE_IP is None:
                _NODE_IP = _detect_node_ip()
            ip = _NODE_IP
    return ip


def _detect_node_ip() -> str:
    ip = os.environ.get("RTT_NODE_IP", "").strip()
    if ip:
        return ip
    try:
        ip = socket.gethostbyname(socket.gethostname())
        if ip and not ip.startswith("127."):
            return ip
    except OSError:
        pass
    return "127.0.0.1"


def host_of(address: str) -> str:
    """Host part of a ``host:port`` address ('' for unix endpoints)."""
    if not address or address.startswith("unix:") or address.startswith("/"):
        return ""
    if address.startswith("tcp:"):
        address = address[4:]
    return address.rsplit(":", 1)[0]


def same_host(address: str) -> bool:
    """True when ``address`` is served from this node (so its unix
    sibling is reachable). Unix endpoints are same-host by definition;
    ``host:port`` matches loopback or our advertised IP, unless the
    harness forces everything off-box."""
    if not address:
        return False
    if address.startswith("unix:") or address.startswith("/"):
        return True
    if force_tcp():
        return False
    host = host_of(address)
    return host in ("localhost", "127.0.0.1", node_ip())


def pick(unix_address, tcp_address) -> str:
    """Dial-side endpoint choice from a peer's advertised pair. Prefer
    the unix path when the peer is on this box (or advertises nothing
    else); otherwise the TCP endpoint. '' when neither is advertised."""
    unix_address = unix_address or ""
    tcp_address = tcp_address or ""
    if unix_address and (not tcp_address or same_host(tcp_address)):
        return unix_address
    return tcp_address or unix_address


def partitioned(peer_host: str) -> bool:
    """The ``net.partition`` chaos site: drop ONE direction of a host
    pair. A spec with ``method="<src_ip>>{dst_ip}"`` severs frames from
    src to dst while leaving the reverse direction up — the classic
    asymmetric partition that heals via reconnect/fallback."""
    if not peer_host:
        return False
    from ray_tpu_torch._private import chaos
    if not chaos.enabled():
        return False
    act = chaos.hit("net.partition", f"{node_ip()}>{peer_host}")
    return bool(act) and act.get("op") == "partition"


def _reset_for_tests():
    global _NODE_IP
    with _NODE_IP_LOCK:
        _NODE_IP = None
