"""Port parity, the LM dry-run counts against the reference's: the port's
``roofline.structured.count_step`` (the count that ``launch.dryrun`` and
``launch.roofline_run`` write) beside the reference's
``repro.roofline.structured.structured_roofline`` (XLA's ``cost_analysis``
and the collectives parsed from the compiled HLO, per component, times the
trip counts) on the same (2, 4) ("data", "model") mesh: the reference on 8
forced host devices in a subprocess, the port on a ``"fake"`` group of 8.

Smoke widths, train (batch 8 × 64, one microbatch), prefill (8 × 64) and
decode (batch 8, cache 128), for a dense (gemma-2b), an MoE
(mixtral-8x7b, 4 experts: expert-parallel on the 4-way axis) and an SSM
(mamba2-1.3b) arch.  Stated factors, port / reference:

- FLOPs per device within [0.5, 1.5] for all three.  The port counts
  ``FlopCounterMode``'s formulas (matmuls and attention products) on each
  device's local ops; XLA also counts elementwise work (softmax, norms,
  the SSD scan's exponentials) and the port counts MoE's dense E·cap
  expert slots.  Measured: 0.62–1.21.
- Collective result bytes per device within [1/3, 3].  DTensor's
  redistributions are not XLA's collectives (an all-gather and a
  reduce-scatter where XLA may pick a collective-permute or an
  all-reduce; mamba's column-sharded projections are gathered before
  they are split, where XLA permutes the pieces).  Measured: 0.38–2.93.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["gemma-2b", "mixtral-8x7b", "mamba2-1.3b"]
KINDS = ["train", "prefill", "decode"]
FLOPS_FACTOR = (0.5, 1.5)
COLLECTIVE_FACTOR = (1 / 3, 3.0)

_REF = """
    import json, sys, jax, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_config, smoke_config
    from repro.configs.base import ShapeConfig
    from repro.roofline.structured import structured_roofline
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    shapes = {"train": ShapeConfig("t", "train", 64, 8),
              "prefill": ShapeConfig("p", "prefill", 64, 8),
              "decode": ShapeConfig("d", "decode", 128, 8)}
    out = {}
    for arch in sys.argv[1].split(","):
        for kind, shape in shapes.items():
            r = structured_roofline(smoke_config(get_config(arch)), shape, mesh)
            out[f"{arch}/{kind}"] = {k: r[k] for k in ("flops_per_device",
                                                       "collective_bytes_per_device")}
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def counts():
    """(the reference's counts, the port's), each by "arch/kind"."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.roofline.structured import count_step

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REF), ",".join(ARCHS)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    shapes = {"train": ShapeConfig("t", "train", 64, 8),
              "prefill": ShapeConfig("p", "prefill", 64, 8),
              "decode": ShapeConfig("d", "decode", 128, 8)}
    port = {}
    with fake_group(8):
        mesh = make_debug_mesh(2, 4, device_type="cpu")
        for arch in ARCHS:
            for kind, shape in shapes.items():
                sc = count_step(smoke_config(get_config(arch)), shape, mesh)
                port[f"{arch}/{kind}"] = {
                    "flops_per_device": sc.counter.flops,
                    "collective_bytes_per_device": float(sum(sc.counter.collectives.values()))}
    out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-6000:]
    return json.loads(out.strip().splitlines()[-1]), port


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_dryrun_counts_within_stated_factors_of_reference(counts, arch, kind):
    ref, port = (c[f"{arch}/{kind}"] for c in counts)
    lo, hi = FLOPS_FACTOR
    f = port["flops_per_device"] / ref["flops_per_device"]
    assert lo <= f <= hi, (arch, kind, "flops", f)
    lo, hi = COLLECTIVE_FACTOR
    c = port["collective_bytes_per_device"] / ref["collective_bytes_per_device"]
    assert lo <= c <= hi, (arch, kind, "collective bytes", c)
