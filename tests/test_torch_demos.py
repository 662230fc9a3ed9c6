"""The port's copies of the four root demos (peritext_tpu_torch/examples/)
against the JAX package's (examples/), each run as a script in its own
process: the same stdout, apart from comment ids, which the bridge draws
at random on every run.  The web demo's script mode drives its HTTP Patch
protocol headlessly (as tests/test_web_demo.py does) and must converge,
and its server serves the port's own copy of the page."""
import os
import re
import subprocess
import sys
from pathlib import Path
from urllib.request import urlopen

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_EXAMPLES = REPO / "peritext_tpu_torch" / "examples"
TIMEOUT = 60
_COMMENT_ID = re.compile(r"comment-[0-9a-f]{8}")


def _run(script: Path) -> str:
    env = dict(os.environ, JAX_PLATFORMS="cpu", LIVE_LATENCY="0.05")
    proc = subprocess.run([sys.executable, str(script), "--script"], capture_output=True, text=True,
                          timeout=TIMEOUT, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return _COMMENT_ID.sub("comment-<id>", proc.stdout)


@pytest.mark.parametrize("demo", ["essay_demo", "live_demo", "interactive_demo", "web_demo"])
def test_port_demo_prints_what_the_jax_demo_prints(demo):
    port = _run(PORT_EXAMPLES / f"{demo}.py")
    assert port.strip()
    assert port == _run(REPO / "examples" / f"{demo}.py")
    if demo == "web_demo":
        assert "tabs converged via Patch protocol" in port


def test_web_demo_serves_its_own_page():
    from peritext_tpu_torch.examples import web_demo

    server = web_demo.serve(0)
    try:
        with urlopen(f"http://127.0.0.1:{server.server_address[1]}/", timeout=10) as resp:
            page = resp.read()
    finally:
        server.shutdown()
        server.server_close()
    assert page == (PORT_EXAMPLES / "web" / "index.html").read_bytes()
    assert b"peritext_tpu_torch/examples/web_demo.py" in page
