"""Port parity for ``ncf_tpu_torch.naming`` against ``ncf_tpu.naming``:
the template client's names from one seed, parsing and validation of the
same lines, and ``HttpTextClient``'s requests and retries against one
loopback server script (the retry contract of reference
vertex_client.py:55-74: 5xx and transport errors back off and retry, 4xx
raises at once).  Everything is stdlib code, so every comparison is
exact.
"""

import json
import threading
import urllib.error
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

import ncf_tpu.naming as jnaming
import ncf_tpu_torch.naming as tnaming
from ncf_tpu.naming.http_client import HttpTextClient as JClient
from ncf_tpu_torch.naming.http_client import HttpTextClient as TClient


def test_exports_and_prompts_equal():
    assert tnaming.__all__ == jnaming.__all__
    assert tnaming.CATEGORY_PROMPTS == jnaming.CATEGORY_PROMPTS
    for cat in list(tnaming.CATEGORY_PROMPTS)[:4]:
        assert (tnaming.prompt_for_category(cat, 7)
                == jnaming.prompt_for_category(cat, 7))


@pytest.mark.parametrize("seed", [0, 5])
def test_template_names_equal(seed):
    cats = list(tnaming.CATEGORY_PROMPTS)[:6] + ["UNKNOWN"]
    t = tnaming.ProductNameGenerator(seed=seed).generate_catalog(
        {c: 12 for c in cats})
    j = jnaming.ProductNameGenerator(seed=seed).generate_catalog(
        {c: 12 for c in cats})
    assert {c: [vars(p) for p in ps] for c, ps in t.items()} == {
        c: [vars(p) for p in ps] for c, ps in j.items()}


LINES = ["Classic Soda #1 (12 oz)", "Spicy Pizza (Large) [Extra Cheese]",
         "no size here", "Vegan Gluten-Free Iced Coffee (16 oz) [Light Ice]",
         "", "Hot Dog (Single) [No Onions, Toasted]"]


@pytest.mark.parametrize("line", LINES)
def test_parse_and_validate_equal(line):
    cat = list(tnaming.CATEGORY_PROMPTS)[0]
    assert ([vars(p) for p in tnaming.parse_response(line)]
            == [vars(p) for p in jnaming.parse_response(line)])
    assert (tnaming.validate_line_format(line)
            == jnaming.validate_line_format(line))
    assert (tnaming.validate_category_keywords(line, cat)
            == jnaming.validate_category_keywords(line, cat))


class _Handler(BaseHTTPRequestHandler):
    def do_POST(self):
        n = len(self.server.requests)
        body = self.rfile.read(int(self.headers["Content-Length"]))
        self.server.requests.append(json.loads(body))
        script = self.server.script
        action = script[min(n, len(script) - 1)]
        if action == "ok":
            payload = json.dumps({"text": "Classic Soda (12 oz)"}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(payload)
        else:
            self.send_response(int(action))
            self.end_headers()

    def log_message(self, *a):
        pass


def _drive(client_cls, script):
    """One client against a fresh loopback server running ``script``
    (None: an unreachable port); what the server saw and what the
    client did."""
    srv = None
    if script is None:
        url = "http://127.0.0.1:9/gen"
    else:
        srv = HTTPServer(("127.0.0.1", 0), _Handler)
        srv.requests, srv.script = [], script
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}/gen"
    sleeps = []
    client = client_cls(url, timeout_s=2.0, max_attempts=3, backoff_s=0.5,
                        extra_body={"model": "m"}, sleep=sleeps.append)
    try:
        try:
            result = ("ok", client("name 3 products for category code BEV"))
        except urllib.error.HTTPError as e:
            result = ("HTTPError", e.code)
        except RuntimeError as e:
            result = ("RuntimeError", str(e), type(e.__cause__).__name__)
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
    return {"result": result, "attempts": client.attempts_made,
            "sleeps": sleeps,
            "requests": None if srv is None else srv.requests}


@pytest.mark.parametrize("script,attempts", [
    (["ok"], 1), (["503", "503", "ok"], 3), (["400"], 1), (["500"], 3),
    (None, 3)], ids=["ok", "503-503-ok", "400", "500", "unreachable"])
def test_http_client_requests_and_retries_equal(script, attempts):
    port, ref = _drive(TClient, script), _drive(JClient, script)
    assert port == ref
    assert port["attempts"] == attempts
