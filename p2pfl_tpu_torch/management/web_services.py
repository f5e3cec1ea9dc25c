"""REST client of a p2pfl-web-style dashboard (counterpart of
``p2pfl_tpu/management/web_services.py``).

Six endpoints authenticated by an ``x-api-key`` header, stdlib only
(urllib). A failed request is logged at debug level and swallowed: a dead
dashboard never takes training down.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from typing import Optional

from p2pfl_tpu_torch.management.logger import logger


class WebServices:
    def __init__(self, url: str, api_key: str, timeout: float = 5.0) -> None:
        self.url = url.rstrip("/")
        self.api_key = api_key
        self.timeout = timeout
        self._node_key: Optional[str] = None
        self._lock = threading.Lock()

    # ---- endpoints ----

    def register_node(self, node: str, is_simulated: bool = False) -> None:
        resp = self._post("/node", {"address": node, "is_simulated": is_simulated})
        if resp is not None:
            with self._lock:
                self._node_key = resp.get("node_key")

    def unregister_node(self, node: str) -> None:
        self._post("/node-stop", {"address": node})

    def send_log(self, time: str, node: str, level: str, message: str) -> None:
        self._post("/node-log", {"time": time, "address": node, "level": level, "message": message})

    def send_local_metric(self, exp: str, round: int, metric: str, node: str, step: int, value: float) -> None:  # noqa: A002
        self._post(
            "/node-metric/local",
            {"experiment": exp, "round": round, "metric": metric, "address": node, "step": step, "value": value},
        )

    def send_global_metric(self, exp: str, round: int, metric: str, node: str, value: float) -> None:  # noqa: A002
        self._post(
            "/node-metric/global",
            {"experiment": exp, "round": round, "metric": metric, "address": node, "value": value},
        )

    def send_system_metric(self, node: str, metric: str, value: float, time: str) -> None:
        self._post("/node-metric/system", {"address": node, "metric": metric, "value": value, "time": time})

    # ---- plumbing ----

    def _post(self, path: str, payload: dict) -> Optional[dict]:
        req = urllib.request.Request(
            self.url + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json", "x-api-key": self.api_key},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read().decode() or "{}")
        except (urllib.error.URLError, OSError, ValueError) as exc:
            logger.debug("web-services", f"POST {path} failed: {exc}")
            return None
