"""Address parsing for network transports (a copy of ``p2pfl_tpu/communication/address.py``).

Reference: ``p2pfl/communication/grpc/address.py`` — IPv4, IPv6 and unix
sockets, with an OS-assigned free port when none is given (:60-63). gRPC
target strings: ``host:port``, ``[v6::addr]:port``, ``unix:/path.sock``.
"""

from __future__ import annotations

import re
import socket
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Address:
    target: str  # the canonical gRPC target string
    kind: str  # "ipv4" | "ipv6" | "unix"
    host: Optional[str] = None
    port: Optional[int] = None


_V6 = re.compile(r"^\[(?P<host>[0-9a-fA-F:]+)\](?::(?P<port>\d+))?$")
_V4 = re.compile(r"^(?P<host>[^:\[\]]+)(?::(?P<port>\d+))?$")


def parse_address(addr: Optional[str] = None) -> Address:
    """Normalize an address, assigning a free port where needed."""
    if addr is None or addr == "":
        addr = "127.0.0.1:0"
    if addr.startswith("unix:"):
        return Address(addr, "unix")
    m = _V6.match(addr)
    if m:
        host = m.group("host")
        port = int(m.group("port") or 0) or free_port(host, socket.AF_INET6)
        return Address(f"[{host}]:{port}", "ipv6", host, port)
    m = _V4.match(addr)
    if m:
        host = m.group("host")
        port = int(m.group("port") or 0) or free_port(host)
        return Address(f"{host}:{port}", "ipv4", host, port)
    raise ValueError(f"unparseable address {addr!r}")


def free_port(host: str = "127.0.0.1", family: int = socket.AF_INET) -> int:
    """OS-assigned free port (reference ``address.py:60-63``)."""
    with socket.socket(family, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]
