"""``python -m causaldiffae_torch.validate_adjacency``: its ``score`` equals
the JAX script's on the cases of ``tests/test_validate_adjacency.py``, and a
2-step CPU run on a tiny preset writes the JAX script's JSON."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from validate_adjacency import score as jax_score  # noqa: E402

from _port_fixtures import one_torch_thread, tiny_kwargs  # noqa: E402,F401
from causaldiffae_torch import validate_adjacency  # noqa: E402

PENDULUM = np.zeros((4, 4))
PENDULUM[0, 2] = PENDULUM[0, 3] = PENDULUM[1, 2] = PENDULUM[1, 3] = 1.0
PARTIAL = np.zeros((4, 4))
PARTIAL[0, 2] = PARTIAL[1, 2] = PARTIAL[2, 0] = 0.3


@pytest.mark.parametrize("A,truth", [
    (np.array([[0.0, 0.4], [0.01, 0.0]]), [[0.0, 1.0], [0.0, 0.0]]),   # perfect recovery
    (np.array([[0.0, 0.01], [0.4, 0.0]]), [[0.0, 1.0], [0.0, 0.0]]),   # reversed edge
    (np.full((2, 2), 0.07), [[0.0, 1.0], [0.0, 0.0]]),                 # uniform A
    (np.eye(2) * 10.0, [[1.0, 0.0], [0.0, 1.0]]),                      # diagonal ignored
    (PARTIAL, PENDULUM),                                               # 4 variables, partial
], ids=["perfect", "reversed", "uniform", "diagonal", "partial_4var"])
def test_score_equals_jax(A, truth):
    assert validate_adjacency.score(A, truth, 0.05) == jax_score(A, truth, 0.05)


def test_learned_A_reads_the_state_dict():
    from causaldiffae_torch.config import Config, create_model

    model = create_model(Config(**tiny_kwargs(learn_adjacency=True)), device="cpu")
    A = validate_adjacency.learned_A(model)
    assert A.shape == (2, 2) and np.all(A == 0.0)   # zero-init, as the reference's
    with pytest.raises(KeyError):
        validate_adjacency.learned_A(create_model(Config(**tiny_kwargs()), device="cpu"))


def test_two_step_cpu_run_writes_the_json(tmp_path, monkeypatch, capsys, one_torch_thread):  # noqa: F811
    from causaldiffae_torch.config import Config

    cfg = Config(**tiny_kwargs(batch_size=4))
    monkeypatch.setattr(validate_adjacency, "get_config", lambda name: cfg)
    out = tmp_path / "adj.json"
    res = validate_adjacency.main(["--steps", "2", "--seeds", "0", "--device", "cpu",
                                   "--out", str(out)])
    saved = json.loads(out.read_text())
    assert saved == json.loads(json.dumps(res))
    assert set(saved) == {"preset", "steps", "threshold", "truth", "runs", "pooled"}
    assert set(saved["pooled"]) == {"tp", "fp", "fn", "precision", "recall"}
    run = saved["runs"][0]
    assert run["seed"] == 0 and np.isfinite(np.asarray(run["A"])).all()
    assert np.asarray(run["A"]).shape == (2, 2) and saved["truth"] == [[0.0, 1.0], [0.0, 0.0]]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == saved["pooled"]
