"""The control comes out not correct, at the CPU's sizes: the program served
at Q1.23 judged against Q1.25, and the reference in bfloat16 put in the
float32 program's place.  (On the card the same is read at each cell's own
size by ``control.py``.)"""
from portbench import control, harness


def test_program_at_the_next_format_down_fails_the_exact_check(tiny_cell):
    cell = tiny_cell("gnp_2e5.q25.saturate")
    good = harness.run_cell(cell, 5, 0.4, False, device="cpu")
    bad = harness.run_cell(control.lowered(cell), 5, 0.4, False, device="cpu")
    assert good["correct"] is True
    assert bad["correct"] is False
    assert bad["checks"]["raw_gap_lsb"]["value"] > 0
    assert bad["checks"]["rank_mismatch"]["value"] > 0


def test_reference_in_bfloat16_fails_the_float_check(tiny_cell):
    cell = tiny_cell("pl_2e5.f32.saturate")
    numbers = control.bf16_numbers(cell, 5, 64, "cpu")
    limits = harness.json.loads(
        (harness.HERE / "checks" / f"{cell.traffic['check']}.json").read_text())["limits"]
    assert numbers["checked"] == 64
    # the control has to fail one of the numbers, not each: at this size
    # bfloat16 moves every score and seldom swaps two ranks
    assert numbers["score_gap"] > limits["score_gap"]
