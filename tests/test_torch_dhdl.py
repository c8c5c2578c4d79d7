"""Port conformance: the .dhd language (lexer, parser, compiler, serializer,
library) against the reference package's, on the same text.

Compiled designs must equal the reference's bit for bit, serialized text byte
for byte, and errors letter for letter (message and source span).
"""
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._hypothesis_compat import given, settings, st

import repro.core.dhdl as jdhdl
import repro.core.params as jparams
import repro.workloads as jwl
import repro_torch.core.dhdl as tdhdl
import repro_torch.core.params as tparams
import repro_torch.workloads as twl

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parents[1]
LIBRARY = sorted(p.name for p in (ROOT / "src" / "repro" / "configs" / "arch").glob("*.dhd"))
INVALID = sorted(p.name for p in (ROOT / "tests" / "data" / "dhdl_invalid").glob("*.dhd"))


def _leaves_equal(port, ref) -> None:
    """Every float32 leaf of a port tree equals the reference tree's, bit for bit."""
    for f in dataclasses.fields(ref):
        got, want = getattr(port, f.name).cpu().numpy(), np.asarray(getattr(ref, f.name))
        assert got.dtype == np.float32 and got.shape == want.shape, f.name
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), f.name


def _same_design(port: tdhdl.CompiledArch, ref: jdhdl.CompiledArch) -> None:
    assert port.name == ref.name
    assert dataclasses.asdict(port.spec) == dataclasses.asdict(ref.spec)
    _leaves_equal(port.arch, ref.arch)
    _leaves_equal(port.tech, ref.tech)


def _error(fn, *args, **kw) -> str:
    with pytest.raises(ValueError) as ei:
        fn(*args, **kw)
    assert type(ei.value).__name__ == "DhdlError"
    return str(ei.value)


class TestLibrary:
    @pytest.mark.parametrize("fn", LIBRARY)
    def test_dhd_copies_are_byte_identical(self, fn):
        port = pathlib.Path(tdhdl.library_dir()) / fn
        assert port.read_bytes() == (ROOT / "src" / "repro" / "configs" / "arch" / fn).read_bytes()

    def test_library_dir_is_the_ports_own(self):
        assert pathlib.Path(tdhdl.library_dir()) == ROOT / "src" / "repro_torch" / "configs" / "arch"
        assert sorted(p.name for p in pathlib.Path(tdhdl.library_dir()).glob("*.dhd")) == LIBRARY
        assert tdhdl.library_archs() == jdhdl.library_archs()

    @pytest.mark.parametrize("name", jdhdl.library_archs())
    def test_arch_compiles_bit_equal(self, name):
        _same_design(tdhdl.load_arch(name, CPU), jdhdl.load_arch(name))

    @pytest.mark.parametrize("name", jdhdl.library_archs())
    def test_serialized_text_byte_identical(self, name):
        port, ref = tdhdl.load_arch(name, CPU), jdhdl.load_arch(name)
        text = tdhdl.serialize_arch(port)
        assert text == jdhdl.serialize_arch(ref)
        again = tdhdl.parse_arch(text, env={}, device=CPU)
        _same_design(again, ref)
        assert tdhdl.serialize_arch(again) == text

    def test_unknown_library_arch_error_matches(self):
        assert _error(tdhdl.load_arch, "ghost", CPU) == _error(jdhdl.load_arch, "ghost")

    def test_compiled_arch_delegates_to_the_ports_simulator(self):
        port, ref = tdhdl.load_arch("edge", CPU), jdhdl.load_arch("edge")
        g_port, g_ref = twl.get_workload("lstm", device=CPU), jwl.get_workload("lstm")
        for f in dataclasses.fields(ref.specialize()):
            np.testing.assert_allclose(getattr(port.specialize(), f.name).numpy(),
                                       np.asarray(getattr(ref.specialize(), f.name)), rtol=1e-6, err_msg=f.name)
        np.testing.assert_allclose(float(port.simulate(g_port).cycles), float(ref.simulate(g_ref).cycles), rtol=1e-5)

    def test_compile_takes_a_device(self):
        ca = tdhdl.parse_arch("arch a { frequency = 2 GHz }", env={}, device=CPU)
        assert all(x.device.type == "cpu" for x in ca.arch.leaves() + ca.tech.leaves())


# --------------------------------------------------------------------------- #
# the parse cases of tests/test_dhdl.py, each through both packages
# --------------------------------------------------------------------------- #

PARSE_CASES = {
    "units": """
        arch a {
          frequency = 2 GHz
          memory globalBuf { capacity = 4MiB  bank_size = 32 KiB }
          tech { memory mainMem { cell_read_latency = 10 ns } }
        }
        """,
    "comments_and_defaults": "# hi\narch a { // nothing overridden\n }\n",
    "inherit_and_multiplier": """
        arch parent { memory globalBuf { capacity = 10 MiB } }
        arch child inherits parent {
          memory globalBuf { capacity *= 2 }
          tech { memory globalBuf { cell_read_latency *= 0.5 } }
        }
        """,
    "banks_derive_bank_size": "arch a { memory mainMem { capacity = 1 GiB  banks = 1024 } }",
    "enabled_false": "arch a { compute fpu { enabled = false } memory localMem { enabled = false } }",
    "mem_type": "arch a { memory globalBuf { type = rram } }",
    "vdd_0.9": "arch a { tech { vdd = 0.9 } }",
    "vdd_0.45": "arch a { tech { vdd = 0.45 } }",
    "vdd_multiplier": "arch a { tech { vdd = 1.2 } }\narch b inherits a { tech { vdd *= 0.5 } }",
    "last_arch_default": "arch a { frequency = 1 GHz }\narch b { frequency = 2 GHz }",
    "every_section": """
        arch full {
          frequency = 1.25 GHz
          memory localMem { capacity = 2 MiB bank_size = 8 KiB read_ports = 4 bw = 2 type = sram }
          memory mainMem { capacity = 8 GB banks = 64 bw_scale = 0.75 type = dram enabled = yes }
          compute systolicArray { x = 32 y = 16 count = 3 }
          compute vector { width = 64 count = 2 }
          compute macTree { x = 16 y = 4 tile_x = 2 tile_y = 2 }
          compute fpu { count = 2 enabled = on }
          tech {
            node = 7 nm
            peripheral_node = 12 nm
            vdd = 0.7
            memory globalBuf { wire_cap = 0.3 wire_resist = 1.5 cell_read_latency = 400 ps
                               cell_access_device = 1.2 cell_read_power = 0.02 cell_leakage_power = 0.001
                               cell_area = 0.12 peripheral_node = 16 nm }
            compute vector { node = 5 nm wire_cap = 0.1 wire_resist = 0.9 }
          }
        }
        """,
    "inherits_library": "arch mine inherits datacenter { memory globalBuf { capacity *= 2 } }",
}


@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_parse_case_matches_reference(case):
    src = PARSE_CASES[case]
    env = None if case == "inherits_library" else {}
    ref = jdhdl.parse_arch(src, env=env)
    port = tdhdl.parse_arch(src, env=env, device=CPU)
    _same_design(port, ref)
    assert tdhdl.serialize_arch(port) == jdhdl.serialize_arch(ref)


def test_parse_by_name_matches_reference():
    src = PARSE_CASES["last_arch_default"]
    _same_design(tdhdl.parse_arch(src, name="a", env={}, device=CPU), jdhdl.parse_arch(src, name="a", env={}))


def test_ast_matches_reference():
    src = PARSE_CASES["every_section"]
    assert repr(tdhdl.parse(src, "x.dhd")) == repr(jdhdl.parse(src, "x.dhd"))


ERROR_CASES = {
    "unknown_unit": ("arch a {\n  frequency = 2 GHzz\n}", "x.dhd"),
    "unknown_field": ("arch a { memory mainMem { capcity = 1 GiB } }", "<dhd>"),
    "unknown_memory_unit": ("arch a { memory l2cache { capacity = 1 MiB } }", "<dhd>"),
    "banks_and_bank_size": ("arch a { memory mainMem { banks = 4 bank_size = 1 MiB } }", "<dhd>"),
    "unknown_parent": ("arch a inherits ghost { }", "<dhd>"),
    "inherit_cycle": ("arch a inherits b { }\narch b inherits a { }", "<dhd>"),
    "duplicate_arch": ("arch a { }\narch a { }", "<dhd>"),
    "nonpositive_value": ("arch a { memory mainMem { capacity = 0 } }", "<dhd>"),
    "bad_mem_type": ("arch a { memory mainMem { type = flash } }", "<dhd>"),
    "unclosed_block": ("arch a { memory mainMem { capacity = 1 GiB ", "<dhd>"),
    "muleq_type": ("arch a { memory mainMem { type *= 2 } }", "<dhd>"),
    "muleq_enabled": ("arch a { compute fpu { enabled *= 0 } }", "<dhd>"),
    "unexpected_character": ("arch a { frequency = 2 GHz ; }", "y.dhd"),
    "no_arch": ("# only a comment\n", "z.dhd"),
    "all_compute_disabled": ("arch a { compute systolicArray { enabled = false } compute vector { enabled = false }"
                             " compute macTree { enabled = false } compute fpu { enabled = false } }", "<dhd>"),
    "vdd_range": ("arch a { tech { vdd = 3 } }", "<dhd>"),
    "bad_multiplier": ("arch a { memory mainMem { capacity *= -2 } }", "<dhd>"),
    "not_arch": ("memory a { }", "<dhd>"),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_error_text_matches_reference(case):
    src, fn = ERROR_CASES[case]
    assert _error(tdhdl.parse_arch, src, filename=fn, env={}, device=CPU) == _error(
        jdhdl.parse_arch, src, filename=fn, env={})


@pytest.mark.parametrize("fn", INVALID)
def test_invalid_corpus_error_text_matches_reference(fn):
    src = (ROOT / "tests" / "data" / "dhdl_invalid" / fn).read_text()
    assert _error(tdhdl.parse_arch, src, filename=fn, env={}, device=CPU) == _error(
        jdhdl.parse_arch, src, filename=fn, env={})


# --------------------------------------------------------------------------- #
# random designs: serialized text byte-identical, round trips bit-exact
# --------------------------------------------------------------------------- #


def _random_design(rng: np.random.Generator):
    """A design inside the DOpt bounds (log-uniform), random memory types and
    enabled units, as both packages' CompiledArch."""
    leaves = {}
    for cls in (jparams.ArchParams, jparams.TechParams):
        lo, hi = cls.bounds()
        for f in dataclasses.fields(cls):
            a, b = np.log(np.asarray(getattr(lo, f.name))), np.log(np.asarray(getattr(hi, f.name)))
            leaves[cls.__name__, f.name] = np.exp(a + (b - a) * rng.random(a.shape)).astype(np.float32)
    comp_on = rng.random(len(jparams.COMP_CLS)) < 0.6
    comp_on[rng.integers(len(comp_on))] = True
    mem_on = rng.random(len(jparams.MEM_CLS)) < 0.7
    spec = dict(mem_units=tuple(m for m, e in zip(jparams.MEM_CLS, mem_on) if e),
                comp_units=tuple(c for c, e in zip(jparams.COMP_CLS, comp_on) if e),
                mem_type=tuple(jparams.MEM_TYPES[i] for i in rng.integers(3, size=3)))

    def build(pkg, dhdl, to):
        trees = {c: getattr(pkg, c)(**{f: to(v) for (cn, f), v in leaves.items() if cn == c})
                 for c in ("ArchParams", "TechParams")}
        return dhdl.CompiledArch(name="prop", spec=pkg.ArchSpec(**spec), arch=trees["ArchParams"],
                                 tech=trees["TechParams"])

    return build(tparams, tdhdl, torch.tensor), build(jparams, jdhdl, jnp.asarray)


@pytest.mark.parametrize("seed", range(12))
def test_random_design_serializes_byte_identically(seed):
    port, ref = _random_design(np.random.default_rng(seed))
    text = tdhdl.serialize_arch(port)
    assert text == jdhdl.serialize_arch(ref)
    again = tdhdl.parse_arch(text, env={}, device=CPU)
    _same_design(again, jdhdl.parse_arch(text, env={}))
    assert tdhdl.serialize_arch(again) == text


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2**32 - 1))
def test_hypothesis_design_serializes_byte_identically(seed):
    port, ref = _random_design(np.random.default_rng(seed))
    assert tdhdl.serialize_arch(port) == jdhdl.serialize_arch(ref)
