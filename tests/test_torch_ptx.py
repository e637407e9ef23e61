"""The PTX front-end (`repro_torch.core.ptx_frontend`) on short PTX written
here, in the shape `nvcc -ptx -lineinfo` gives the port's RMSNorm kernels:
a 2-stage `cp.async` ring (one group committed before the loop, one per
iteration, `wait_group 1` for the older) and a kernel of plain
`ld.global` loads.  No nvcc is needed."""
import pytest

from repro_torch.core import (EdgeKind, OpClass, SyncKind, analyze_module,
                              from_ptx, ptx_entries)
from repro_torch.core.ptx_frontend import CP_ASYNC_COUNTER, find_entry

RING = """
.version 8.7
.target sm_90a
.address_size 64

.visible .entry _Z4ringIfEvPKT_PS0_l(
	.param .u64 _Z4ringIfEvPKT_PS0_l_param_0,
	.param .u64 _Z4ringIfEvPKT_PS0_l_param_1,
	.param .u64 _Z4ringIfEvPKT_PS0_l_param_2
)
{
	.reg .pred 	%p<3>;
	.reg .f32 	%f<4>;
	.reg .b32 	%r<8>;
	.reg .b64 	%rd<12>;
	.loc	1 20 0
	ld.param.u64 	%rd1, [_Z4ringIfEvPKT_PS0_l_param_0];
	ld.param.u64 	%rd2, [_Z4ringIfEvPKT_PS0_l_param_1];
	ld.param.u64 	%rd3, [_Z4ringIfEvPKT_PS0_l_param_2];
	mov.u32 	%r1, 0;
	mov.u64 	%rd4, 0;
	.loc	1 22 3
	.loc	1 8 3, function_name $L__info_string0, inlined_at 1 22 3
	// begin inline asm
	cp.async.cg.shared.global [%r1], [%rd1], 16;

	// end inline asm
	.loc	1 23 3
	.loc	1 12 3, function_name $L__info_string1, inlined_at 1 23 3
	// begin inline asm
	cp.async.commit_group;

	// end inline asm
$L__BB0_1:
	.loc	1 25 5
	add.s64 	%rd5, %rd1, 16;
	xor.b32  	%r2, %r1, 16;
	.loc	1 8 3, function_name $L__info_string0, inlined_at 1 26 5
	// begin inline asm
	cp.async.cg.shared.global [%r2], [%rd5], 16;

	// end inline asm
	.loc	1 12 3, function_name $L__info_string1, inlined_at 1 27 5
	// begin inline asm
	cp.async.commit_group;

	// end inline asm
	.loc	1 16 3, function_name $L__info_string2, inlined_at 1 28 5
	// begin inline asm
	cp.async.wait_group 1;

	// end inline asm
	.loc	1 29 5
	bar.sync 	0;
	.loc	1 30 5
	ld.shared.f32 	%f1, [%r1];
	mul.f32 	%f2, %f1, %f1;
	.loc	1 0 5
	st.global.f32 	[%rd2], %f2;
	.loc	1 31 5
	bar.sync 	0;
	add.s64 	%rd4, %rd4, 1;
	setp.lt.s64 	%p1, %rd4, %rd3;
	@%p1 bra 	$L__BB0_1;
	.loc	1 33 1
	ret;

}
	.file	1 "/src/ring.cu"
"""

PLAIN = """
.version 8.7
.target sm_90a
.address_size 64

.visible .entry _Z5plainIfEvPKT_PS0_(
	.param .u64 _Z5plainIfEvPKT_PS0__param_0,
	.param .u64 _Z5plainIfEvPKT_PS0__param_1
)
{
	.reg .f32 	%f<4>;
	.reg .b64 	%rd<4>;
	.loc	1 5 0
	ld.param.u64 	%rd1, [_Z5plainIfEvPKT_PS0__param_0];
	ld.param.u64 	%rd2, [_Z5plainIfEvPKT_PS0__param_1];
	.loc	1 6 3
	ld.global.nc.f32 	%f1, [%rd1];
	ld.global.nc.v2.f32 	{%f2, %f3}, [%rd1+4];
	.loc	1 7 3
	{ add.f32 %f1, %f1, %f2;}
	st.global.f32 	[%rd2], %f1;
	ret;

}
	.file	1 "/src/plain.cu"
"""


def _module(text):
    (entry,) = ptx_entries(text)
    return from_ptx(text, entry)


def test_ring_sets_and_waits():
    module = _module(RING)
    instrs = list(module.all_instructions())
    commits = [i for i in instrs if i.opcode == "cp.async.commit_group"]
    waits = [i for i in instrs if i.opcode == "cp.async.wait_group"]
    # one commit before the loop, the loop laid out twice
    assert len(commits) == 3 and len(waits) == 2
    for c in commits:
        assert c.op_class is OpClass.SYNC_SET
        assert c.sync.kind is SyncKind.WAITCNT
        assert c.sync.sets == (CP_ASYNC_COUNTER,)
        # a commit reads the copies of the group it closes
        assert [module.find(f"c0_entry::{o}").opcode for o in c.operands] \
            == ["cp.async.cg.shared.global"]
    for w in waits:
        assert w.op_class is OpClass.SYNC_WAIT
        assert (w.sync.kind, w.sync.waits, w.sync.counter) == \
            (SyncKind.WAITCNT, (CP_ASYNC_COUNTER,), 1)
    bars = [i for i in instrs if i.opcode == "bar.sync"]
    assert len(bars) == 4 and all(b.sync.kind is SyncKind.BARRIER
                                  for b in bars)
    copies = [i for i in instrs if i.opcode.startswith("cp.async.cg")]
    assert all(i.op_class is OpClass.MEMORY_LOAD and i.bytes_read == 16
               for i in copies)


def test_ring_steady_state_wait_links_previous_commit():
    module = _module(RING)
    instrs = list(module.all_instructions())
    prologue, first, second = [i for i in instrs
                               if i.opcode == "cp.async.commit_group"]
    wait1, wait2 = [i for i in instrs if i.opcode == "cp.async.wait_group"]
    an = analyze_module(module, "nvidia_h100_sxm")
    edges = {(e.producer, e.consumer) for e in an.graph.edges
             if e.kind is EdgeKind.MEM_WAITCNT}
    q = lambda i: i.qualified_name  # noqa: E731
    # the first wait has two groups in flight and drains the older
    assert (q(prologue), q(wait1)) in edges
    # in the steady state the wait is for the previous iteration's group,
    # never the one this iteration just committed
    assert (q(first), q(wait2)) in edges
    assert (q(second), q(wait2)) not in edges
    assert (q(first), q(wait1)) not in edges
    # through the commit to the copy it closed
    (copy,) = first.operands
    assert (f"c0_entry::{copy}", q(wait2)) in edges


def test_plain_loads_give_no_waitcnt_edges():
    module = _module(PLAIN)
    instrs = list(module.all_instructions())
    loads = [i for i in instrs if i.op_class is OpClass.MEMORY_LOAD]
    assert [i.bytes_read for i in loads] == [4.0, 8.0]
    (store,) = [i for i in instrs if i.op_class is OpClass.MEMORY_STORE]
    assert store.bytes_written == 4.0
    add = next(i for i in instrs if i.opcode == "add.f32")
    assert set(add.operands) == {loads[0].name, loads[1].name}
    an = analyze_module(module, "nvidia_h100_sxm")
    assert not [e for e in an.graph.edges if e.kind is EdgeKind.MEM_WAITCNT]


def test_loc_lines_map_to_the_fixture_file():
    module = _module(RING)
    instrs = list(module.all_instructions())
    assert {i.source_file for i in instrs} == {"/src/ring.cu"}
    by_op = {i.opcode: i.source_line for i in instrs}
    # the innermost .loc: the inlined helper's own line, not its call site
    assert by_op["cp.async.wait_group"] == 16
    assert by_op["cp.async.commit_group"] == 12
    assert by_op["bar.sync"] == 31
    # `.loc 1 0 5` carries no line: the store keeps the line before it
    assert by_op["st.global.f32"] == 30
    assert by_op["ld.param.u64"] == 20


def test_find_entry_by_kernel_and_type():
    text = RING + PLAIN
    assert find_entry(text, "ring", "float32") == "_Z4ringIfEvPKT_PS0_l"
    with pytest.raises(KeyError):
        find_entry(text, "ring", "bfloat16")
