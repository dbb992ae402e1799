"""The harness on the CPU: the import rule, the yardstick's counts against
hand counts, every file found by its name, and the result line."""

import io
import json
import os
import re
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from conftest import BENCH, ROOT, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("modules, found", [
    (["veles_torch", "veles_torch.znicz.step", "velesx", "jaxtyping"], []),
    (["veles", "veles.znicz_tpu"], ["veles"]),
    (["jax.numpy"], ["jax"]),
    (["jaxlib", "flax.linen"], ["flax", "jaxlib"]),
])
def test_import_rule_compares_whole_top_level_names(monkeypatch, modules,
                                                    found):
    import harness
    fake = {name: None for name in modules}
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_modules() == found


def test_lm_flops_per_token_hand_count():
    import yardstick
    # 12·(4·768² + 2·768·3072) + 768·30522 matmul weights, 6 FLOPs each,
    # and 6·(512 + 1)·768 a layer for the causal core
    n_mm = 12 * (4 * 768 * 768 + 2 * 768 * 3072) + 768 * 30522
    assert n_mm == 108375552
    want = 6 * n_mm + 6 * 12 * 513 * 768
    assert want == 678620160
    assert yardstick.lm_train_flops_per_token(768, 12, 3072, 30522,
                                              512) == want
    model = load("configs", "lm110m.json")["model"]
    traffic = load("traffic", "s512.b64.json")
    assert yardstick.lm_step_flops(model, traffic) == want * 64 * 512


def test_lm_attention_work_hand_count():
    import yardstick
    model = load("configs", "lm110m.json")["model"]
    traffic = load("traffic", "s8k.b4.json")
    flops, nbytes = yardstick.lm_attention_step_work(model, traffic)
    tokens = 4 * 8192
    assert flops == 12 * tokens * (24 * 768 ** 2 + 6 * 8193 * 768)
    weights = 4 * 768 * 768 + 4 * 768
    assert nbytes == 12 * (4 * tokens * 768 * 2 + 3 * weights * 4)


def test_alexnet_counts_hand_count():
    import yardstick
    model = load("configs", "alexnet.json")["model"]
    macs = {name: d["macs"] for kind, name, d in
            yardstick.alexnet_layers(model) if kind in ("conv", "fc")}
    assert macs == {
        "conv1": 55 * 55 * 96 * 11 * 11 * 3,
        "conv2": 27 * 27 * 256 * 5 * 5 * 96,
        "conv3": 13 * 13 * 384 * 3 * 3 * 256,
        "conv4": 13 * 13 * 384 * 3 * 3 * 384,
        "conv5": 13 * 13 * 256 * 3 * 3 * 384,
        "fc6": 6 * 6 * 256 * 4096, "fc7": 4096 * 4096, "fc8": 4096 * 1000}
    total = sum(macs.values())
    assert total == 1135256096
    assert yardstick.alexnet_train_flops_per_image(model) == 6 * total
    traffic = load("traffic", "b256.json")
    rows = [256 * 55 * 55, 256 * 27 * 27, 256 * 13 * 13, 256 * 13 * 13,
            256 * 13 * 13, 256, 256, 256]
    ks = [96, 256, 384, 384, 256, 4096, 4096, 1000]
    want = sum((1 if i == 7 else 2) * n * k * 2 + k * 4
               for i, (n, k) in enumerate(zip(rows, ks)))
    assert yardstick.alexnet_bias_grad_step_bytes(model, traffic) == want


def test_peaks_and_roofline():
    import yardstick
    row = yardstick.peaks("NVIDIA H100 80GB HBM3")
    assert row["bf16"] == 989.4e12
    assert yardstick.roofline_seconds(989.4e12, 0, row) == 1.0
    assert yardstick.roofline_seconds(0, 3.35e12, row) == 1.0
    with pytest.raises(KeyError):
        yardstick.peaks("cpu")


def test_every_cell_config_and_metric_is_found_by_name():
    import harness
    b = bench()
    for w in b["workloads"]:
        cell = harness.load_cell(b, w["name"])
        assert cell.chips == w["chips"]
        assert set(cell.limits) == {
            prefix + name for prefix in ("", "late_")
            for name in ("loss_gap", "grad_gap", "update_gap")}
        assert hasattr(cell.family, "make_inputs")
    for c in b["configs"]:
        config = load("configs", c["name"] + ".json")
        assert c["file"] == "benchmark/configs/%s.json" % c["name"]
        assert config["name"] == c["name"]
        assert config["reduced"] == c["reduced"]
        assert config["source"] == c["source"]
        assert os.path.exists(os.path.join(
            BENCH, "reference", config["family"] + ".py"))
    for m in b["per_layer"]:
        reader = harness.load_reader(m["name"])
        assert callable(reader.read)


def test_benchmark_json_keeps_the_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
    for w in b["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        reports = [m for m in b["end_to_end"] + b["per_layer"]
                   if w["name"] in m.get("workloads", [w["name"]])]
        assert len([m for m in reports if m in b["end_to_end"]]) >= 2
        assert any(m in b["per_layer"] for m in reports)


def test_result_line_keys_and_check_last(tiny_lm):
    import harness
    result = harness.run_cell(tiny_lm, 2 ** 33 + 5, 0.5, 0, device="cpu")
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        harness.emit(result)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "check"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert set(line["check"]) == {
        prefix + name for prefix in ("", "late_")
        for name in ("loss_gap", "grad_gap", "update_gap")}
    last = err.getvalue().strip().splitlines()[-6:]
    assert [w.split()[1] for w in last] == list(line["check"])
    assert all("limit" in w for w in last)


def test_run_refuses_a_host_without_a_card(capsys):
    import run
    if __import__("torch").cuda.is_available():
        pytest.skip("this host has a card")
    assert run.main(["--workload", "lm110m.s512.b64", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
