"""The check catches a broken timed path: a run driven through the harness
(without its look for a card) with a fault planted under the service comes
out not correct.  The cells run on one card, so no fault of an exchange
between cards applies."""
import pytest
import torch

from portbench import harness

CELLS = [w["name"] for w in harness.json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _unchanged_state(orig):
    def step(topo, val, dang_idx, vmat, p, **kw):
        return p, orig(topo, val, dang_idx, vmat, p, **kw)[1]
    return step


def _half_batch_dropped(orig):
    def step(topo, val, dang_idx, vmat, p, **kw):
        p_next, res = orig(topo, val, dang_idx, vmat, p, **kw)
        p_next = p_next.clone()
        p_next[:, p_next.shape[1] // 2:] = 0
        return p_next, res
    return step


def _answer_altered(make_topk):
    def make(self, topk_tile):
        topk = make_topk(self, topk_tile)

        def altered(P, k, exclude):
            idx, vals = topk(P, k, exclude)
            idx = idx.clone()
            idx[0, :2] = torch.flip(idx[0, :2], dims=(0,))
            return idx, vals
        return altered
    return make


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch_dropped",
                                   "answer_altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_planted_fault_makes_the_run_not_correct(workload, fault, tiny_cell,
                                                   monkeypatch):
    from repro_torch.ppr_serving.engine import base, fused

    if fault == "answer_altered":
        monkeypatch.setattr(base.WaveEngine, "_make_topk",
                            _answer_altered(base.WaveEngine._make_topk))
    else:
        wrap = _unchanged_state if fault == "unchanged_state" else _half_batch_dropped
        monkeypatch.setattr(fused, "fused_ppr_iteration", wrap(fused.fused_ppr_iteration))
    result = harness.run_cell(tiny_cell(workload), 77, 0.4, False, device="cpu")
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
