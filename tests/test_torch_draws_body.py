"""The Hopper draw kernel's own logic (K2), on the CPU: csrc/draws.cuh (the
per-(row, node) draw body the CUDA kernel runs) compiled with g++ through the
plain C harness csrc/draws_host.cpp, loaded with ctypes and driven through
the same leaf checks, pointer table and outputs as the CUDA wrapper
(kernels/draw_engine.py `draw_host`). It is held against the plain draws
(sim/faults.py `make_inputs`, `draw_span`, `trace_fault_inputs`), which
tests/test_torch_inputs.py holds against the JAX package: on every preset,
a numpy-seeded genome, per-row ticks, spans and the fault facts, and the
partition side bits staged once a row in both worker orders with the
staging poisoned; and its threefry functions against utils/threefry.py and
jax.random.
tests/test_torch_draws_jax.py holds the body against the JAX package
directly, alone and with the tick kernel's host body in `simulate`.

Tolerance: exact equality of every StepInputs leaf and fault fact (value,
dtype, shape; the packed delivery mask compared as uint32 through its
int32 carrier), and of every ClusterState and RunMetrics leaf.
Skips only where no g++ is installed.
"""

import dataclasses
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_sim_tpu_torch.kernels import draw_engine
from raft_sim_tpu_torch.models import raft_batched as trb
from raft_sim_tpu_torch.scenario import genome as gmod
from raft_sim_tpu_torch.sim import faults
from raft_sim_tpu_torch.types import StepInputs
from raft_sim_tpu_torch.utils import config as tconfig
from raft_sim_tpu_torch.utils import threefry

torch.set_num_threads(1)

# Every tick of the first 41, then the edges of the crash windows (64 ticks
# at every crash preset), config8's first toggle (97), the second window's
# end, and ticks far out (a tick past 2^20 enters the key as its uint32).
TICKS = list(range(41)) + [63, 64, 65, 96, 97, 127, 128, 129, 1000, 2**20 + 3]
SEG_LEN = 8


@pytest.fixture(scope="module")
def lib():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    return draw_engine.load_host(draw_engine.host_library(gxx))


def _flat(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    names = getattr(tree, "_fields", None) or [str(k) for k in range(len(tree))]
    return [leaf for name, x in zip(names, tree) for leaf in _flat(x, f"{prefix}.{name}")]


def assert_same(want, got, what: str) -> None:
    """Every leaf of `got` equals `want`'s: value, dtype and shape."""
    a, b = _flat(want), _flat(got)
    assert [n for n, _ in a] == [n for n, _ in b], what
    for (name, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, (
            f"{what}{name}: {x.dtype} {tuple(x.shape)} != {y.dtype} {tuple(y.shape)}")
        assert torch.equal(x, y), f"{what}{name}: values differ"


def minor(tree, axis: int = 0):
    """The plain draws' leaves (StepInputs, fault facts) in the kernel's
    layout: the batch axis `axis` moved last."""
    if isinstance(tree, torch.Tensor):
        return tree.movedim(axis, -1).contiguous()
    out = [minor(x, axis) for x in tree]
    return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)


def raw_genome(cfg, batch: int, segments: int, seed: int) -> gmod.ScenarioGenome:
    """A `[batch, segments]` genome from a numpy seed, every leaf random and
    unvalidated: thresholds over the whole uint32 range (a quarter of them
    0), cadences from 0 (off) up, partition periods from 0 -- so every
    mechanism draws, the ones `cfg` gates off too."""
    rng = np.random.default_rng(seed)

    def u32():
        x = rng.integers(0, 2**32, size=(batch, segments), dtype=np.int64)
        x[rng.random((batch, segments)) < 0.25] = 0
        return x

    def ints(lo, hi):
        return rng.integers(lo, hi, size=(batch, segments))

    vals = dict(drop=u32(), part_period=ints(0, 12), part=u32(), crash=u32(),
                crash_down=ints(1, cfg.crash_period + 1), skew=u32(), client_interval=ints(0, 5),
                reconfig_interval=ints(0, 6), transfer_interval=ints(0, 6), read_interval=ints(0, 4),
                fsync_interval=ints(0, 4), fsync_jitter=u32(), torn=u32(),
                torn_span=ints(1, cfg.log_capacity + 1))
    return gmod.ScenarioGenome(**{f: torch.tensor(vals[f], dtype=gmod.leaf_dtype(f))
                                  for f in gmod.ScenarioGenome._fields})


def test_ptr_enum_and_params_match_the_wrapper():
    """csrc/draws.cuh's Ptr enum lists the leaves in PTR_ORDER's order, and
    its DrawParams fields in DrawParams._fields_' order."""
    src = (draw_engine.CSRC / "draws.cuh").read_text()
    body = src[src.index("enum Ptr {"):src.index("N_PTR")]
    names = re.findall(r"\b([A-Z])_([A-Z_]+)\b", body)
    groups = {"D": None, "G": "genome", "O": "inputs", "F": "facts"}
    got = [(groups[p] or n.lower(), n.lower()) for p, n in names]
    assert got == list(draw_engine.PTR_ORDER)
    struct = src[src.index("struct DrawParams {"):src.index("};", src.index("struct DrawParams {"))]
    fields = [f for decl in re.findall(r"^\s*(?:u?int\d+_t)\s+([^;]+);", struct, re.M)
              for f in re.split(r",\s*", decl)]
    assert fields == [f for f, _ in draw_engine.DrawParams._fields_]


def _words(rng, n):
    return rng.integers(0, 2**32, size=n, dtype=np.int64)


def _host_threefry(lib, op, keys, x0, x1=None, lo=0, hi=0):
    n = len(x0)
    k = np.ascontiguousarray(keys.astype(np.uint32))
    a = np.ascontiguousarray(x0.astype(np.uint32))
    b = np.ascontiguousarray((x1 if x1 is not None else x0).astype(np.uint32))
    out = np.zeros(2 * n if op < 2 else n, dtype=np.uint32)
    lib.rs_draws_threefry(op, n, k.ctypes.data, a.ctypes.data, b.ctypes.data, lo, hi,
                          out.ctypes.data)
    return out.astype(np.int64)


@pytest.mark.parametrize("span", [(0, 5), (3, 17), (1, 256), (0, 65536), (0, 70000),
                                  (-4, 2**31 - 1)], ids=lambda s: f"{s[0]}-{s[1]}")
def test_threefry_functions_match_utils_threefry(lib, span):
    """The body's threefry2x32, fold_in/split, bits and randint equal
    utils/threefry.py's on numpy-seeded keys and words, and randint equals
    jax.random.randint's (spans past 2^16 included: the multiplier's square
    wraps as uint32)."""
    rng = np.random.default_rng(span[1])
    n = 64
    kw = _words(rng, 2 * n).reshape(n, 2)
    x0, x1 = _words(rng, n), _words(rng, n)
    keys = torch.from_numpy(kw)
    b1, b2 = threefry.threefry2x32(keys[:, 0], keys[:, 1], torch.from_numpy(x0),
                                   torch.from_numpy(x1))
    got = _host_threefry(lib, 0, kw.reshape(-1), x0, x1).reshape(n, 2)
    assert np.array_equal(got, torch.stack([b1, b2], -1).numpy())
    folded = torch.stack([threefry.fold_in(keys[j], int(x0[j])) for j in range(n)])
    assert np.array_equal(_host_threefry(lib, 1, kw.reshape(-1), x0).reshape(n, 2), folded.numpy())
    assert np.array_equal(threefry.split(keys, 4)[:, 3].numpy(),
                          _host_threefry(lib, 1, kw.reshape(-1), np.full(n, 3)).reshape(n, 2))
    pos = rng.integers(0, 300, size=n)
    bits = torch.stack([threefry.bits(keys[j], (300,))[pos[j]] for j in range(n)])
    assert np.array_equal(_host_threefry(lib, 2, kw.reshape(-1), np.zeros(n), pos), bits.numpy())
    lo, hi = span
    ri = torch.stack([threefry.randint(keys[j], (300,), lo, hi)[pos[j]] for j in range(n)])
    got_ri = _host_threefry(lib, 3, kw.reshape(-1), pos, lo=lo, hi=hi).astype(np.uint32).view(np.int32)
    assert np.array_equal(got_ri, ri.numpy())
    jkey = jax.random.wrap_key_data(jnp.asarray(kw[0].astype(np.uint32)))
    want = np.asarray(jax.random.randint(jkey, (300,), lo, hi, dtype=jnp.int32))
    assert np.array_equal(want, threefry.randint(keys[0], (300,), lo, hi).numpy())


def _check_ticks(lib, cfg, keys, ticks, genome=None, seg_len=1, what=""):
    for t in ticks:
        want = minor(faults.make_inputs(cfg, keys, t, genome=genome, seg_len=seg_len, facts=True))
        got = draw_engine.draw_host(lib, cfg, keys, t, genome, seg_len, facts=True)
        assert_same(want, got, f"{what} tick {t}")
        if t % 8 == 0:  # without the facts: the plain draws' inputs do not depend on them
            assert_same(want[0], draw_engine.draw_host(lib, cfg, keys, t, genome, seg_len),
                        f"{what} tick {t} no facts")


PRESET_ROWS = [pytest.param(name, 2 if tconfig.PRESETS[name][0].n_nodes > 100 else 6, id=name)
               for name in tconfig.PRESETS]


@pytest.mark.parametrize("name,batch", PRESET_ROWS)
def test_draw_body_matches_plain_draws(lib, name, batch):
    """Every PRESETS entry at B <= 8: each TICKS tick's StepInputs and fault
    facts from the body equal the plain draws'; the run drew restarts where
    the preset crashes nodes."""
    cfg = tconfig.PRESETS[name][0]
    keys = threefry.split(threefry.key(3), batch)
    ticks = TICKS if cfg.n_nodes <= 100 else TICKS[::3]
    _check_ticks(lib, cfg, keys, ticks, what=name)
    if cfg.crash_prob > 0:
        restarts = sum(int(draw_engine.draw_host(lib, cfg, keys, t).restarted.sum())
                       for t in range(130))
        assert restarts > 0


GENOME_ROWS = ["config6r", "config8", "config10", "config5c", "config7x"]


@pytest.mark.parametrize("name", GENOME_ROWS)
def test_draw_body_matches_plain_on_a_genome(lib, name):
    """The genome path: a numpy-seeded three-segment genome with every leaf
    random, segments of SEG_LEN ticks, every tick 0..40 (the segment edges
    and the final segment held past the program's end)."""
    cfg = tconfig.PRESETS[name][0]
    batch = 3 if cfg.n_nodes > 100 else 6
    keys = threefry.split(threefry.key(11), batch)
    g = raw_genome(cfg, batch, 3, seed=1)
    ticks = range(41) if cfg.n_nodes <= 100 else range(0, 41, 3)
    _check_ticks(lib, cfg, keys, ticks, genome=g, seg_len=SEG_LEN, what=f"{name} genome")


@pytest.mark.parametrize("name", ["config6r", "config10", "config5c"])
def test_per_row_ticks_and_spans_match_plain(lib, name):
    """Per-row ticks (`now` a [B] int32 tensor) and `draw_span`'s rows --
    one call over (tick, cluster) rows -- equal the plain draws', with the
    facts."""
    cfg = tconfig.PRESETS[name][0]
    batch = 3 if cfg.n_nodes > 100 else 6
    keys = threefry.split(threefry.key(5), batch)
    g = raw_genome(cfg, batch, 3, seed=2)
    now = torch.tensor([0, 7, 8, 17, 40, 1][:batch], dtype=torch.int32)
    for facts in (False, True):
        assert_same(minor(faults.make_inputs(cfg, keys, now, genome=g, seg_len=SEG_LEN,
                                             facts=facts)),
                    draw_engine.draw_host(lib, cfg, keys, now, g, SEG_LEN, facts=facts),
                    f"{name} per-row facts={facts}")
        assert_same(minor(faults.draw_span(cfg, keys, 3, 12, g, SEG_LEN, facts=facts), 1),
                    draw_engine.draw_host(lib, cfg, keys, 3, g, SEG_LEN, facts=facts, ticks=12),
                    f"{name} span facts={facts}")


def test_tick_zero_facts(lib):
    """Tick 0's facts: nothing crashed (tick -1 reports alive) and no cut
    before tick 0, on the scalar and the genome path."""
    cfg = tconfig.PRESETS["config6"][0]
    cfg = dataclasses.replace(cfg, partition_period=4, partition_prob=1.0)
    keys = threefry.split(threefry.key(9), 8)
    for g in (None, raw_genome(cfg, 8, 2, seed=4)):
        want = minor(faults.make_inputs(cfg, keys, 0, genome=g, seg_len=SEG_LEN, facts=True))
        got = draw_engine.draw_host(lib, cfg, keys, 0, g, SEG_LEN, facts=True)
        assert_same(want, got, "tick 0")
        crashed, cut_now, cut_prev = got[1]
        assert not crashed.any() and not got[0].restarted.any() and not cut_prev.any()
    assert bool((cut_now > 0).any())  # the scalar window at tick 0 cut edges


def test_wrapper_rejects_bad_leaves(lib):
    cfg = tconfig.PRESETS["config6"][0]
    keys = threefry.split(threefry.key(1), 4)
    g = raw_genome(cfg, 4, 2, seed=3)
    with pytest.raises(ValueError, match="keys"):
        draw_engine.draw_host(lib, cfg, keys.to(torch.int32), 0)
    with pytest.raises(ValueError, match="not contiguous"):
        draw_engine.draw_host(lib, cfg, keys.t().contiguous().t(), 0)
    with pytest.raises(TypeError, match="per-row"):
        draw_engine.draw_host(lib, cfg, keys, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="genome.crash"):
        draw_engine.draw_host(lib, cfg, keys, 0, g._replace(crash=g.crash.to(torch.int32)))
    with pytest.raises(ValueError, match="now"):
        draw_engine.draw_host(lib, cfg, keys, torch.zeros(4, dtype=torch.int64), g)
    with pytest.raises(NotImplementedError, match="crash_period"):
        draw_engine.draw_host(lib, dataclasses.replace(cfg, crash_prob=0.0, crash_period=0), keys,
                              0, g)
    with pytest.raises(ValueError, match="meta"):
        draw_engine.draw_cuda(cfg, keys.to("meta"), 0)


def test_cpu_keys_dispatch_to_the_plain_draws(monkeypatch):
    """`draw_cuda` and `draw_span` on CPU keys are the plain draws (the
    kernel runs only on the card), in the kernel's batch-minor layout."""
    cfg = tconfig.PRESETS["config10"][0]
    keys = threefry.split(threefry.key(2), 3)
    assert_same(trb.to_batch_minor(faults.make_inputs(cfg, keys, 5)),
                draw_engine.draw_cuda(cfg, keys, 5), "inputs")
    want = faults.make_inputs(cfg, keys, 5, facts=True)
    got = draw_engine.draw_cuda(cfg, keys, 5, facts=True)
    assert_same(trb.to_batch_minor(want[0]), got[0], "inputs with facts")
    assert_same((want[1][0].movedim(0, -1),) + tuple(want[1][1:]), got[1], "facts")
    g = raw_genome(cfg, 3, 2, seed=6)
    for facts in (False, True):
        span = faults.draw_span(cfg, keys, 0, 4, g, SEG_LEN, facts=facts)
        got = draw_engine.draw_span(cfg, keys, 0, 4, g, SEG_LEN, facts=facts)
        assert_same(minor(span, 1), got, f"span facts={facts}")
        inps = got[0] if facts else got
        assert_same(trb.to_batch_minor(faults.make_inputs(cfg, keys, 2, genome=g,
                                                          seg_len=SEG_LEN)),
                    StepInputs(*(x[2] for x in inps)), "span row 2")
    launches = draw_engine.draw_cuda.launches
    monkeypatch.setattr(draw_engine, "_cuda_launch", lambda *a: pytest.fail("launched on the CPU"))
    draw_engine.draw_cuda(cfg, keys, 6)
    assert draw_engine.draw_cuda.launches == launches


@pytest.mark.parametrize("name,blocks", [("config3", 15), ("config6", 50), ("config6r", 69),
                                         ("config7x", 65_545)])
def test_threefry_blocks_pinned(name, blocks):
    """K2's bound counts (per cluster at tick 5): config3 draws the key
    chain (5) and the timeouts' split and 2N bits (10) only; config6 adds
    k_drop and the N^2 drop bits (26) and the crash schedule (k_part, its
    fold, a window key, k_sel and N selection bits: 9); config6r the
    redirect routing (19 at K = 5); config7x the 1 + 65,025 drop blocks and
    the partition window (k_part, the window key, k_active and its bit)."""
    cfg = tconfig.PRESETS[name][0]
    assert draw_engine.threefry_blocks(cfg, 1, 5) == blocks
    assert draw_engine.threefry_blocks(cfg, 10, 5) == 10 * blocks
    rd, wr = draw_engine.traffic_bytes(cfg, 1)
    inp = faults.make_inputs(cfg, threefry.split(threefry.key(0), 1), 5)
    assert rd == 16 and wr == sum(x.numel() * x.element_size() for x in inp)


def test_step_inputs_fields_are_the_outputs():
    assert [f for g, f in draw_engine.PTR_ORDER if g == "inputs"] == list(StepInputs._fields)


def _listing(body: list[str], name: str = "_ZN4anon12draws_kernelEN2rd8DrawArgsE") -> str:
    """A cuobjdump -sass listing of draw kernel `name`: a region of `body`
    that a predicate branches over, before it a lone block outside any
    loop, the region inside a loop, and another function after."""
    decoy = ["SHF.L.W.U32.HI R1, R1, 0xd, R1"] * 20 + ["ISETP.LT.U32.AND P0, PT, R1, R2, PT"]
    lines = ["ISETP.NE.AND P3, PT, R9, RZ, PT", *decoy, "BSSY B0, END"]
    top = len(lines)
    lines += ["@!P3 BRA END", *body, "BSYNC B0", "ISETP.GE.AND P0, PT, R4, R5, PT",
              f"@!P0 BRA {top * 16:#x}", "EXIT"]
    end = (lines.index("BSYNC B0")) * 16
    out = [f"\t\tFunction : {name}"]
    out += [f"        /*{k * 16:04x}*/    {ln.replace('END', f'{end:#x}')} ;  /* 0x0 */"
            for k, ln in enumerate(lines)]
    out += ["\t\tFunction : other", "        /*0000*/    SHF.L.W.U32.HI R1, R1, 0xd, R1 ;"]
    return "\n".join(out)


def test_block_ops_come_from_the_drop_loop_sass():
    """`parse_block_ops` counts the one drop draw of draws_kernel's SASS:
    the region an innermost loop branches over that holds one threefry
    block (20 rotates) and ends in an unsigned compare; an add is the only
    instruction the FMA pipe may take. `bound_ms` prices a block at the
    slower of its ALU-only instructions over 64 lanes and all of them over
    128."""
    body = (["IADD3 R42, P0, R43, R36, RZ", "LEA.HI.X.SX32 R44, R43, R29, 0x1, P0"]
            + ["IMAD.IADD R44, R44, 0x1, R45", "SHF.L.W.U32.HI R45, R45, 0xf, R45",
               "LOP3.LUT R45, R44, R45, RZ, 0x3c, !PT"] * 20
            + ["IADD3 R47, R45, R47, R24"] * 6 + ["@P2 IMAD.IADD R42, R21, 0x1, R42",
                                                 "LOP3.LUT R42, R42, R47, RZ, 0x3c, !PT",
                                                 "ISETP.LT.U32.AND P0, PT, R42, R9, PT"])
    assert draw_engine.parse_block_ops(_listing(body)) == {"total": 71, "alu_only": 43}
    with pytest.raises(ValueError, match="no drop draw"):
        draw_engine.parse_block_ops(_listing(body[:-1]))
    # Both draw kernels in one listing: the leaner form's draw prices the
    # bound, whichever comes first (one more add, then one more rotate-free
    # ALU op, in the tile's).
    flat = _listing(body, "_ZN4anon17draws_flat_kernelEN2rd8DrawArgsE")
    for extra, want in ((["IADD3 R47, R45, R47, R24"], {"total": 71, "alu_only": 43}),
                        (["LOP3.LUT R42, R42, R47, RZ, 0x3c, !PT"], {"total": 71, "alu_only": 43})):
        tile = _listing(body[:-1] + extra + body[-1:])
        assert draw_engine.parse_block_ops(tile + "\n" + flat) == want
        assert draw_engine.parse_block_ops(flat + "\n" + tile) == want
    assert draw_engine.parse_block_ops(_listing(body[:-1] + ["LOP3.LUT R1, R1, R2, RZ, 0x3c, !PT"]
                                                + body[-1:])) == {"total": 72, "alu_only": 44}
    cfg = tconfig.PRESETS["config7"][0]
    blocks = draw_engine.threefry_blocks(cfg, 100, 5)
    alu = draw_engine.bound_ms(cfg, 100, 5, 1980.0, block_ops={"total": 71, "alu_only": 43})
    assert alu["ops_ms"] == pytest.approx(blocks * 43 / 64 / (132 * 1980e6) * 1e3)
    issue = draw_engine.bound_ms(cfg, 100, 5, 1980.0, block_ops={"total": 100, "alu_only": 20})
    assert issue["ops_ms"] == pytest.approx(blocks * 100 / 128 / (132 * 1980e6) * 1e3)
    assert alu["bound_by"] == "operations" and alu["int32_ops"] == 71 * blocks


# A partition's side bits staged once a row (csrc/draws.cuh `stage_node`): N
# at the tile edges the card's blocks take (8 rows of 33 and of 51 nodes, 2
# of 255; batches that leave a ragged last tile), a window of 8 ticks cut at
# p = 0.5 so most windows are active, drop on so both parts of a delivery
# row show, and ticks at and beside each window edge (the facts' tick before
# in another window).
STAGED_TICKS = [0, 1, 2, 7, 8, 9, 15, 16, 17, 24, 31, 32, 33, 40]


def staged_cfg(n: int):
    return dataclasses.replace(tconfig.PRESETS["config7"][0], n_nodes=n, partition_period=8,
                               partition_prob=0.5, drop_prob=0.1)


@pytest.mark.parametrize("order", ["forward", "reverse-poison"])
@pytest.mark.parametrize("n,batch", [(33, 11), (51, 9), (255, 3)], ids=["n33", "n51", "n255"])
def test_staged_side_bits_match_plain(lib, n, batch, order):
    """The staged body (each node's side bit drawn once, read by every node
    of its row after the stage phase, the cut counts from the staged rows)
    equals the plain draws with the facts, in the forward worker order and
    in reverse with the staging poisoned before each tile's stage phase;
    some window cut edges and some tick's cut differed from the tick
    before."""
    assert draw_engine._host_tile_rows(lib, n) == {33: 8, 51: 8, 255: 2}[n]
    cfg = staged_cfg(n)
    keys = threefry.split(threefry.key(13), batch)
    cut, changed = 0, 0
    rev = order != "forward"
    for t in STAGED_TICKS:
        want = minor(faults.make_inputs(cfg, keys, t, facts=True))
        got = draw_engine.draw_host(lib, cfg, keys, t, facts=True, reverse=rev, poison=rev)
        assert_same(want, got, f"n={n} {order} tick {t}")
        cut += int((got[1][1] > 0).sum())
        changed += int((got[1][1] != got[1][2]).sum())
    assert cut > 0 and changed > 0
