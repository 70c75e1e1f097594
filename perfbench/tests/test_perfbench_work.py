"""The yardstick's frozen work counts: hand-worked from the scenes'
definitions, and equal to the program's code generator today."""

import json

import pytest
import torch

from perfbench.harness import spec, yardstick

CFG = {n: json.loads((spec.BENCH_DIR / "configs" / f"{n}.json").read_text())
       for n in ("scene2_4k", "siren_w256_512")}


def _sin_fast_ops():
    # round(x/2π): mul + round; two-term reduction: 4; r²: 1; Horner over
    # five coefficients: 2 + 4·2; r·p: 1
    return 2 + 4 + 1 + 2 + 8 + 1


def hand_counts():
    sphere = 3 + 2 + 1 + 1           # x², y², z², two adds, sqrt, - r
    box = 6 + 2 + 3 + 6 + 1 + 1      # |p| - h, two maxes, three relus,
    #                                   the norm, the inside select, the add
    onion = 2
    torus = 10
    line = 3 + 5 + 1 + 2 + 6 + 6 + 1
    scene2 = sphere + box + onion + torus + line + 3  # three union selects
    width, act = 256, _sin_fast_ops()
    layer0 = 2 * 3 * width + width + act * width  # products, w0 scale, act
    layer1 = 2 * width * width + act * width
    layer2 = 2 * width
    neural = sphere + layer0 + layer1 + layer2 + 1
    siren = neural + box + onion + 1
    mm = 2 * (3 * width + width * width + width)
    return {"scene2_4k": (scene2, 0, 0),
            "siren_w256_512": (siren, mm, 2 * mm)}


@pytest.mark.parametrize("name", sorted(CFG))
def test_frozen_counts_are_hand_worked(name):
    ops, mm_eval, mm_vjp = hand_counts()[name]
    w = CFG[name]["work"]
    assert w["ops_per_eval"] == ops
    assert w["matmul_flops_per_eval"] == mm_eval
    assert w["matmul_flops_per_vjp"] == mm_vjp


@pytest.mark.parametrize("name", sorted(CFG))
def test_frozen_counts_equal_the_code_generator(name):
    from ray_marching_tpu_torch.scene.codegen import SdfProgram
    from ray_marching_tpu_torch.scene.graph import compile_scene, param_paths
    from ray_marching_tpu_torch.scene.serialize import node_from_dict

    node = node_from_dict(CFG[name]["scene"])
    prog = SdfProgram(node)
    w = CFG[name]["work"]
    assert prog.ops_per_eval == w["ops_per_eval"]
    assert prog.vjp_ops_per_eval == w["ops_per_vjp"]
    _, _, params = compile_scene(node, torch.float32, "cpu")
    assert sum(v.numel() for v in param_paths(params).values()) \
        == w["param_scalars"]


def test_least_times():
    peaks = CFG["siren_w256_512"]["peaks"]
    rays = 512 * 512
    fwd = yardstick.forward_work(CFG["siren_w256_512"], rays)
    assert fwd.matmul_flops == rays * 29 * 133120
    assert fwd.least_seconds(peaks) == pytest.approx(
        rays * 29 * 133120 / 495e12)
    s2 = yardstick.train_step_work(CFG["scene2_4k"], 3840 * 2160)
    per_ray = 37 * 65 + 36 * (226 - 65) + 2 * (32 * 6 + 45)
    assert s2.other_ops == pytest.approx(3840 * 2160 * per_ray + 12 * 14)
    assert s2.least_seconds(peaks) == pytest.approx(s2.other_ops / 67e12)
