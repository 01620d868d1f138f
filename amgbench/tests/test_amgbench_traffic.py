"""The requests are drawn from the seed alone, and the mix's pieces are
found by their names."""

import importlib

import pytest
import torch

from amgbench import fields, spec
from amgbench.harness import Requests, Reservoir

from conftest import tiny_cell

SEED = 2 ** 31 + 977


@pytest.mark.parametrize("name", ["poisson2d_4096.rhs_stream",
                                  "poisson2d_csr_2048.rhs_stream",
                                  "hpcg27_104.rhs_stream"])
def test_rhs_stream_repeats_by_seed(name):
    cell = tiny_cell(name)
    a = Requests(cell.config, cell.traffic, SEED, "cpu")
    b = Requests(cell.config, cell.traffic, SEED, "cpu")
    c = Requests(cell.config, cell.traffic, SEED + 1, "cpu")
    for i in (0, 1, 7):
        assert torch.equal(a.solution(i), b.solution(i))
        assert torch.equal(a.make(i), b.make(i))
        assert not torch.equal(a.solution(i), c.solution(i))
        assert torch.equal(a.make(i), a.op.matvec(a.solution(i)))
    assert not torch.equal(a.solution(1), a.solution(2))
    assert not a.new_operator(5)


def test_matrix_stream_repeats_by_seed():
    cell = tiny_cell("poisson2d_4096.rhs_stream")
    traffic = spec.load_traffic("matrix_stream")
    a = Requests(cell.config, traffic, SEED, "cpu")
    b = Requests(cell.config, traffic, SEED, "cpu")
    assert a.new_operator(1) and a.new_operator(2)
    for i in (1, 2):
        assert torch.equal(a.make(i), b.make(i)) and a.op_index == i
        assert torch.equal(a.field(i), b.field(i))
    d1 = a.op.diags.clone()
    a.make(3)
    assert not torch.equal(d1, a.op.diags)
    assert not torch.equal(a.field(1), a.field(3))


def test_coefficient_contrast():
    spec_ = spec.load_traffic("matrix_stream")["coefficients"]
    k = fields.draw(spec_, (40, 40), SEED, fields.COEFFICIENTS, 3, "cpu")
    assert float(k.max() / k.min()) == pytest.approx(spec_["contrast"],
                                                     rel=1e-12)
    const = fields.draw({"kind": "constant", "value": 1.0}, (5, 5), SEED,
                        fields.COEFFICIENTS, 3, "cpu")
    assert torch.all(const == 1)


def test_stream_seed_takes_large_seeds():
    s = fields.stream_seed(2 ** 40 + 5, 0, 3)
    assert 0 <= s < 2 ** 63
    assert s == fields.stream_seed(2 ** 40 + 5, 0, 3)
    assert s != fields.stream_seed(2 ** 40 + 6, 0, 3)


def test_reservoir_is_seeded_and_uniform_in_size():
    picks = []
    for _ in range(2):
        r = Reservoir(4, SEED)
        slots = [r.offer(i) for i in range(100)]
        picks.append(r.kept)
        # an item is kept in the slot offer names, and stays until replaced
        last = {s: i for i, s in enumerate(slots) if s is not None}
        assert [last[s] for s in range(4)] == r.kept
    assert picks[0] == picks[1] and len(picks[0]) == 4
    r = Reservoir(4, SEED + 1)
    for i in range(100):
        r.offer(i)
    assert r.kept != picks[0]
    short = Reservoir(8, SEED)
    for i in range(3):
        short.offer(i)
    assert short.kept == [0, 1, 2]


@pytest.mark.parametrize("mix", ["rhs_stream", "matrix_stream"])
def test_a_mix_names_its_pieces(mix):
    """Every piece a mix names is a module found by that name."""
    traffic = spec.load_traffic(mix)
    loop = importlib.import_module(f"amgbench.loops.{traffic['loop']}")
    assert callable(loop.serve)
    for key in ("solution", "coefficients"):
        mod = importlib.import_module(
            f"amgbench.fields.{fields.kind(traffic[key])}")
        assert callable(mod.draw)


def test_closed_loop_serves_until_over():
    class Window:
        def __init__(self):
            self.served = []

        def over(self, i):
            return i >= 3

        def request(self, i, since=None):
            self.served.append(i)

    w = Window()
    importlib.import_module("amgbench.loops.closed").serve(w, {"clients": 1})
    assert w.served == [1, 2, 3]
    with pytest.raises(ValueError, match="one client"):
        importlib.import_module("amgbench.loops.closed").serve(
            w, {"clients": 4})


def test_unknown_piece_names_itself():
    with pytest.raises(ModuleNotFoundError, match="amgbench.fields.nope"):
        fields.draw({"kind": "nope"}, (3,), SEED, 0, 0, "cpu")
