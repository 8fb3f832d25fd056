"""The example twins (``repro_torch.examples``) on the CPU at their small
sizes:

  * quickstart: the LM demo's shapes and finite numbers, and its database
    demo fed the JAX example's S keys prints what the JAX example's
    ``nam_db_demo`` prints (the committed flag, the CID, the planner's
    choice and the join aggregate);
  * nam_oltp: commits + aborts == sessions over its 8 waves of 512;
  * serve_lm: every request gets its tokens and every slot lock word is 0
    after release;
  * train_lm: ``--tiny --steps 10`` has finite losses, and a second run on
    the same ``--ckpt-dir`` restores and resumes at step 10.
"""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro_torch.examples import nam_oltp, quickstart, serve_lm, train_lm

ROOT = Path(__file__).resolve().parents[1]


def _jax_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_main(capsys):
    out = quickstart.main(["--device", "cpu"])
    assert out["logits_shape"] == [2, 64, 256]
    assert math.isfinite(out["loss"]) and math.isfinite(out["grad_norm"])
    assert len(out["decoded"]) == 2
    assert out["db"]["committed"] and out["db"]["alternatives"] == 4
    assert out["ps"]["epoch_after"] == out["ps"]["epoch_before"] + 1
    assert "ps: epoch 0->1" in capsys.readouterr().out


def test_quickstart_db_demo_prints_jax_s(capsys):
    n = quickstart.JOIN_ROWS
    keys = np.asarray(jax.random.randint(jax.random.PRNGKey(7), (n,), 1,
                                         2 * n).astype(jnp.uint32))
    _jax_example("quickstart").nam_db_demo()
    want = capsys.readouterr().out
    out = quickstart.nam_db_demo(keys, device="cpu")
    assert capsys.readouterr().out == want
    assert f"join aggregate {out['aggregate']} " in want


def test_nam_oltp_counts_every_session():
    out = nam_oltp.main(["--device", "cpu"])
    st = out["txn_stats"]
    assert out["sessions"] == nam_oltp.WAVES * nam_oltp.T
    assert st["commits"] + st["aborts"] == out["sessions"]
    assert st["commits"] == out["committed"] > 0 and st["aborts"] > 0
    assert out["read_timestamp"] == out["sessions"] + 1
    assert out["fabric"]["fetch_add"]["msgs"] == out["sessions"]


def test_serve_lm_releases_every_slot():
    out = serve_lm.main(["--device", "cpu"])
    assert sorted(out["outs"]) == list(range(8))
    assert [len(out["outs"][r]) for r in range(4)] == [6, 8, 10, 12]
    assert out["slot_words"] == [0, 0, 0, 0]


def test_train_lm_resumes_from_its_checkpoint(tmp_path):
    args = ["--tiny", "--steps", "10", "--seq-len", "32", "--global-batch",
            "4", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    first = train_lm.main(args)
    assert not first["resumed"] and first["step"] == 10
    assert first["finite"] and len(first["log"]) == 1
    again = train_lm.main(args)
    assert again["resumed"] and again["start_step"] == 10
    assert again["step"] == 10 and again["log"] == []
