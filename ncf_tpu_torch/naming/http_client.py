"""Concrete remote text client over HTTP JSON — the transport-backed
implementation behind the ``TextClient`` seam.

Capability parity with the reference's live Vertex LLM client
(reference: src/llm/vertex_client.py:41-74 — ``generate`` posts the
prompt to the hosted model and retries failures with 3 bounded attempts
and exponential backoff).  This framework keeps the seam pluggable
(naming/generator.py defaults to the offline template client — zero
egress here), and this module provides the one concrete remote
implementation: a stdlib-urllib JSON client with the same retry policy,
exercised in CI against an in-process HTTP server
(tests/test_naming_http.py).
"""

from __future__ import annotations

import json
import logging
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, Optional

log = logging.getLogger(__name__)


class HttpTextClient:
    """``prompt -> text`` over HTTP POST JSON, with bounded retry.

    Request body: ``{"prompt": <str>}`` (plus ``extra_body`` fields);
    response: JSON whose ``response_field`` (default ``"text"``) holds
    the generated text, or a plain-text body.

    Retry contract (reference vertex_client.py:55-74): up to
    ``max_attempts`` tries; transport errors, timeouts and HTTP 5xx
    back off exponentially (``backoff_s`` initial, doubling); HTTP 4xx
    is a caller error and raises immediately.
    """

    def __init__(
        self,
        url: str,
        timeout_s: float = 30.0,
        max_attempts: int = 3,
        backoff_s: float = 1.0,
        headers: Optional[Dict[str, str]] = None,
        extra_body: Optional[Dict] = None,
        response_field: str = "text",
        sleep: Callable[[float], None] = time.sleep,  # injectable for tests
    ):
        self.url = url
        self.timeout_s = timeout_s
        self.max_attempts = int(max_attempts)
        self.backoff_s = backoff_s
        self.headers = {"Content-Type": "application/json",
                        **(headers or {})}
        self.extra_body = extra_body or {}
        self.response_field = response_field
        self._sleep = sleep
        self.attempts_made = 0      # telemetry for tests/monitoring

    def __call__(self, prompt: str) -> str:
        body = json.dumps({"prompt": prompt, **self.extra_body}).encode()
        delay = self.backoff_s
        last_err: Optional[Exception] = None
        for attempt in range(self.max_attempts):
            self.attempts_made += 1
            req = urllib.request.Request(
                self.url, data=body, headers=self.headers, method="POST")
            try:
                with urllib.request.urlopen(
                        req, timeout=self.timeout_s) as resp:
                    raw = resp.read().decode("utf-8", errors="replace")
                return self._extract(raw)
            except urllib.error.HTTPError as e:
                if 400 <= e.code < 500:
                    raise   # caller error: retrying cannot help
                last_err = e
                log.warning("text endpoint HTTP %d (attempt %d/%d)",
                            e.code, attempt + 1, self.max_attempts)
            except (urllib.error.URLError, TimeoutError, OSError) as e:
                last_err = e
                log.warning("text endpoint unreachable (attempt %d/%d): %s",
                            attempt + 1, self.max_attempts, e)
            if attempt + 1 < self.max_attempts:
                self._sleep(delay)
                delay *= 2
        raise RuntimeError(
            f"text endpoint failed after {self.max_attempts} attempts"
        ) from last_err

    def _extract(self, raw: str) -> str:
        try:
            doc = json.loads(raw)
        except json.JSONDecodeError:
            return raw              # plain-text endpoint
        if isinstance(doc, dict) and self.response_field in doc:
            return str(doc[self.response_field])
        return raw
