"""The port's run utilities against the JAX package's: the stdout tee
``Logger``, ``StepTimer``, the ``trace`` context, and the NaN guard
(``assert_all_finite``, ``checkified``)."""

import io
import json
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WRITES = ["step 1: loss 0.5\n", "", "partial ", "line\n", "ünïcode ✓\n"]


@pytest.mark.parametrize("quiet", [False, True])
def test_logger_tees_the_same_bytes_as_jax(tmp_path, monkeypatch, quiet):
    from ldmseg_tpu.utils.logging import Logger as JLogger
    from ldmseg_torch.utils import Logger
    out = {}
    for name, cls in (("jax", JLogger), ("port", Logger)):
        console = io.StringIO()
        monkeypatch.setattr(sys, "stdout", console)
        path = tmp_path / name / "log.txt"
        logger = cls(str(path), quiet=quiet).install()
        try:
            for w in WRITES:
                print(w, end="")
            logger.flush()
        finally:
            logger.close()
        assert sys.stdout is console
        out[name] = (console.getvalue(), path.read_bytes())
    assert out["port"] == out["jax"]
    assert out["port"][1] == "".join(WRITES).encode()
    assert out["port"][0] == ("" if quiet else "".join(WRITES))


def test_logger_without_a_file_only_writes_the_console(monkeypatch):
    from ldmseg_torch.utils.logging import Logger
    console = io.StringIO()
    monkeypatch.setattr(sys, "stdout", console)
    logger = Logger().install()
    print("x")
    logger.close()
    assert console.getvalue() == "x\n" and logger.file is None


@pytest.mark.parametrize("times", [
    [0.25], [1.5, 0.2, 0.3, 0.25], [3.0, 0.1, 0.1, 0.9, 0.4, 0.2, 0.6]])
def test_step_timer_summary_equals_jax(times):
    from ldmseg_tpu.utils.profiling import StepTimer as JStepTimer
    from ldmseg_torch.utils.profiling import StepTimer
    jt, pt = JStepTimer(), StepTimer()
    jt.times, pt.times = list(times), list(times)
    assert pt.summary() == jt.summary()
    assert pt.summary()["steps"] == len(times)


def test_step_timer_stop_on_cpu_results():
    from ldmseg_torch.utils.profiling import StepTimer
    timer = StepTimer()
    for result in (None, torch.ones(3), {"a": [torch.zeros(2), 1.0]},
                   (torch.ones(1), None)):
        timer.start()
        dt = timer.stop(result)
        assert dt >= 0 and timer.times[-1] == dt
    assert timer.summary()["steps"] == 4


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    from ldmseg_torch.utils.profiling import trace
    logdir = str(tmp_path / "trace")
    with trace(logdir) as d:
        x = torch.randn(32, 32)
        (x @ x).sum()
    assert d == logdir
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) or "mm" in str(
        e.get("name", "")) for e in events)


def _trees():
    rng = np.random.RandomState(0)

    def arr(*shape):
        return rng.randn(*shape).astype(np.float32)
    bad = arr(3)
    bad[1] = np.nan
    inf = arr(2, 2)
    inf[0, 0] = -np.inf
    nested = {"unet": {"conv_in": {"kernel": arr(3, 3), "bias": bad},
                       "down": [arr(2), inf, np.arange(4)]},
              "scale": np.float32(np.inf), "step": 3, "none": None,
              "aux": (arr(1), np.array([np.nan], np.float64))}
    many = {f"w{i:02d}": np.full((2,), np.nan, np.float32)
            for i in range(13)}
    clean = {"a": [arr(2), arr(1, 1)], "b": {"c": np.arange(3)}}
    return {"nested": nested, "more than ten": many, "clean": clean}


def _to_torch(tree):
    """The tree with each array a torch tensor of its own copy."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


def _message(fn, tree):
    try:
        fn(tree, "params")
    except FloatingPointError as e:
        return str(e)
    return None


@pytest.mark.parametrize("name", ["nested", "more than ten", "clean"])
@pytest.mark.parametrize("as_torch", [False, True])
def test_assert_all_finite_names_the_same_leaves_as_jax(name, as_torch):
    from ldmseg_tpu.train.debug import assert_all_finite as jax_check
    from ldmseg_torch.train.debug import assert_all_finite
    tree = _trees()[name]
    want = _message(jax_check, tree)
    mine = _to_torch(tree) if as_torch else _trees()[name]
    assert _message(assert_all_finite, mine) == want
    assert (want is None) == (name == "clean")


def test_assert_all_finite_on_a_module_and_its_state_dict():
    from ldmseg_torch.train.debug import assert_all_finite
    net = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.BatchNorm1d(2))
    assert_all_finite(net)
    with torch.no_grad():
        net[0].bias[1] = float("nan")
        net[1].running_var[0] = float("inf")
    for tree in (net, net.state_dict()):
        with pytest.raises(FloatingPointError) as e:
            assert_all_finite(tree, "net")
        assert str(e.value) == ("non-finite values in net: "
                                "[\"['0.bias']\", \"['1.running_var']\"]")


def test_checkified_raises_on_a_nan_made_inside():
    from ldmseg_tpu.train.debug import checkified as jax_checkified
    from ldmseg_torch.train.debug import checkified

    def step(x):
        y = torch.log(x - 2.0)  # NaN for x < 2
        return {"loss": y.sum(), "aux": [x * 2]}

    def jax_step(x):
        return jax.numpy.log(x - 2.0).sum()

    x = np.array([1.0, 3.0], np.float32)
    with pytest.raises(FloatingPointError, match=r"\['loss'\] of step"):
        checkified(step)(torch.from_numpy(x.copy()))
    with pytest.raises(Exception, match="nan"):
        jax_checkified(jax_step)(x)
    clean = np.array([3.0, 4.0], np.float32)
    out = checkified(step)(torch.from_numpy(clean.copy()))
    assert float(out["loss"]) == pytest.approx(
        float(jax_checkified(jax_step)(clean)), rel=1e-6)
    assert torch.equal(out["aux"][0], torch.from_numpy(clean * 2))


def test_checkified_raises_in_a_backward_that_makes_a_nan():
    from ldmseg_torch.train.debug import checkified

    def step(w):
        # a clean loss whose masked-out branch has a NaN gradient
        loss = torch.where(w > 2, torch.sqrt(w - 2), 0.0).sum()
        loss.backward()
        return loss.detach()

    w = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="SqrtBackward0.*nan"):
        checkified(step)(w)
    assert float(checkified(step)(torch.full((2,), 6.0,
                                              requires_grad=True))) == 4.0
