"""The PTX front-end (`repro_torch.core.ptx_frontend`) on short PTX written
here, in the shape `nvcc -ptx -lineinfo` gives the port's RMSNorm kernels:
a 2-stage `cp.async` ring (one group committed before the loop, one per
iteration, `wait_group 1` for the older) and a kernel of plain
`ld.global` loads, each also with 16-byte vector accesses and bf16 pairs
unpacked (RING_V4, SYNC_V4).  No nvcc is needed."""
import pytest

from repro.core.jaxpr_frontend import _VMEM_BYTE_SCALE
from repro_torch.core import (EdgeKind, OpClass, SyncKind, analyze_module,
                              from_ptx, ptx_entries)
from repro_torch.core.ptx_frontend import (CP_ASYNC_COUNTER,
                                           SHARED_BYTE_SCALE, find_entry)

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


# RING with the reduced value written back to shared memory (as a vector)
# before it goes out: `ld.shared` after the wait, then `st.shared`
SHARED = RING.replace(
    "\tmul.f32 \t%f2, %f1, %f1;\n",
    "\tmul.f32 \t%f2, %f1, %f1;\n"
    "\tst.shared.v2.f32 \t[%r2], {%f2, %f1};\n")


# The 16-byte shapes `nvcc -ptx -lineinfo` gives the redesigned kernels
# (bf16): the ring reads its landed row with `ld.shared.v4.u32` after the
# wait; the baseline loads row and scale with `ld.global.nc.v4.u32`; both
# unpack bf16 pairs with `mov.b32 {%rs..}` and `cvt.f32.bf16` (inline asm
# in braces, from cuda_bf16.hpp) and store with `st.global.v4.u32`.
RING_V4 = """
.version 8.7
.target sm_90a
.address_size 64

.visible .entry _Z6ringv4I13__nv_bfloat16EvPKT_PS1_l(
	.param .u64 _Z6ringv4I13__nv_bfloat16EvPKT_PS1_l_param_0,
	.param .u64 _Z6ringv4I13__nv_bfloat16EvPKT_PS1_l_param_1,
	.param .u64 _Z6ringv4I13__nv_bfloat16EvPKT_PS1_l_param_2
)
{
	.reg .pred 	%p<3>;
	.reg .b16 	%rs<5>;
	.reg .f32 	%f<9>;
	.reg .b32 	%r<8>;
	.reg .b64 	%rd<8>;
	.loc	1 20 0
	ld.param.u64 	%rd1, [_Z6ringv4I13__nv_bfloat16EvPKT_PS1_l_param_0];
	ld.param.u64 	%rd2, [_Z6ringv4I13__nv_bfloat16EvPKT_PS1_l_param_1];
	ld.param.u64 	%rd3, [_Z6ringv4I13__nv_bfloat16EvPKT_PS1_l_param_2];
	mov.u32 	%r1, 0;
	mov.u64 	%rd4, 0;
	.loc	1 8 3, function_name $L__info_string0, inlined_at 1 22 3
	// begin inline asm
	cp.async.cg.shared.global [%r1], [%rd1], 16;

	// end inline asm
	.loc	1 12 3, function_name $L__info_string1, inlined_at 1 23 3
	// begin inline asm
	cp.async.commit_group;

	// end inline asm
$L__BB0_1:
	.loc	1 25 5
	add.s64 	%rd5, %rd1, 512;
	xor.b32  	%r2, %r1, 512;
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
	ld.shared.v4.u32 	{%r3, %r4, %r5, %r6}, [%r1];
	.loc	4 307 1, function_name $L__info_string3, inlined_at 1 31 5
	mov.b32 	{%rs1, %rs2}, %r3;
	.loc	4 585 1, function_name $L__info_string4, inlined_at 1 31 5
	// begin inline asm
	{ cvt.f32.bf16 %f1, %rs1;}

	// end inline asm
	// begin inline asm
	{ cvt.f32.bf16 %f2, %rs2;}

	// end inline asm
	.loc	1 31 5
	fma.rn.f32 	%f3, %f1, %f1, 0f00000000;
	fma.rn.f32 	%f4, %f2, %f2, %f3;
	.loc	4 307 1, function_name $L__info_string3, inlined_at 1 31 5
	mov.b32 	{%rs3, %rs4}, %r6;
	.loc	4 585 1, function_name $L__info_string4, inlined_at 1 31 5
	// begin inline asm
	{ cvt.f32.bf16 %f5, %rs4;}

	// end inline asm
	.loc	1 31 5
	fma.rn.f32 	%f6, %f5, %f5, %f4;
	.loc	1 32 5
	st.global.v4.u32 	[%rd2], {%r3, %r4, %r5, %r6};
	.loc	1 33 5
	bar.sync 	0;
	add.s64 	%rd4, %rd4, 1;
	setp.lt.s64 	%p1, %rd4, %rd3;
	@%p1 bra 	$L__BB0_1;
	.loc	1 35 1
	ret;

}
	.file	1 "/src/ring_v4.cu"
	.file	4 "/cuda/include/cuda_bf16.hpp"
"""

SYNC_V4 = """
.version 8.7
.target sm_90a
.address_size 64

.visible .entry _Z6syncv4I13__nv_bfloat16EvPKT_S2_PS0_(
	.param .u64 _Z6syncv4I13__nv_bfloat16EvPKT_S2_PS0__param_0,
	.param .u64 _Z6syncv4I13__nv_bfloat16EvPKT_S2_PS0__param_1,
	.param .u64 _Z6syncv4I13__nv_bfloat16EvPKT_S2_PS0__param_2
)
{
	.reg .pred 	%p<2>;
	.reg .b16 	%rs<7>;
	.reg .f32 	%f<12>;
	.reg .b32 	%r<13>;
	.reg .b64 	%rd<4>;
	.loc	1 40 0
	ld.param.u64 	%rd1, [_Z6syncv4I13__nv_bfloat16EvPKT_S2_PS0__param_0];
	ld.param.u64 	%rd2, [_Z6syncv4I13__nv_bfloat16EvPKT_S2_PS0__param_1];
	ld.param.u64 	%rd3, [_Z6syncv4I13__nv_bfloat16EvPKT_S2_PS0__param_2];
	.loc	2 131 49, function_name $L__info_string0, inlined_at 1 42 7
	ld.global.nc.v4.u32 {%r1,%r2,%r3,%r4}, [%rd1];
	ld.global.nc.v4.u32 {%r5,%r6,%r7,%r8}, [%rd2];
	.loc	4 307 1, function_name $L__info_string1, inlined_at 1 44 5
	mov.b32 	{%rs1, %rs2}, %r1;
	.loc	4 585 1, function_name $L__info_string2, inlined_at 1 44 5
	// begin inline asm
	{ cvt.f32.bf16 %f1, %rs1;}

	// end inline asm
	// begin inline asm
	{ cvt.f32.bf16 %f2, %rs2;}

	// end inline asm
	.loc	1 44 5
	fma.rn.f32 	%f3, %f1, %f1, 0f00000000;
	fma.rn.f32 	%f4, %f2, %f2, %f3;
	.loc	4 307 1, function_name $L__info_string1, inlined_at 1 44 5
	mov.b32 	{%rs3, %rs4}, %r4;
	.loc	4 585 1, function_name $L__info_string2, inlined_at 1 44 5
	// begin inline asm
	{ cvt.f32.bf16 %f5, %rs4;}

	// end inline asm
	.loc	1 44 5
	fma.rn.f32 	%f6, %f5, %f5, %f4;
	.loc	1 46 3
	shfl.sync.bfly.b32	%r9|%p1, %r10, 16, 31, -1;
	rsqrt.approx.f32 	%f7, %f6;
	.loc	4 307 1, function_name $L__info_string1, inlined_at 1 48 5
	mov.b32 	{%rs5, %rs6}, %r5;
	.loc	4 585 1, function_name $L__info_string2, inlined_at 1 48 5
	// begin inline asm
	{ cvt.f32.bf16 %f8, %rs5;}

	// end inline asm
	.loc	1 48 5
	mul.f32 	%f9, %f1, %f7;
	mul.f32 	%f10, %f9, %f8;
	// begin inline asm
	{ cvt.rn.bf16x2.f32 %r11, %f10, %f10;}

	// end inline asm
	.loc	1 49 5
	st.global.v4.u32 	[%rd3], {%r11, %r2, %r3, %r8};
	.loc	1 51 1
	ret;

}
	.file	1 "/src/sync_v4.cu"
	.file	2 "/cuda/include/sm_32_intrinsics.hpp"
	.file	4 "/cuda/include/cuda_bf16.hpp"
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


def test_shared_memory_traffic_is_memory_at_the_reference_scale():
    """`ld.shared` (after the ring's `cp.async.wait_group`) and
    `st.shared` are a load and a store of on-chip memory, priced at the
    reference's VMEM byte scale, not arithmetic; the ring's waits still
    link to the commits before them."""
    assert "st.shared.v2.f32" in SHARED
    module = _module(SHARED)
    instrs = list(module.all_instructions())
    (load,) = [i for i in instrs if i.opcode == "ld.shared.f32"][:1]
    (store,) = [i for i in instrs if i.opcode == "st.shared.v2.f32"][:1]
    assert load.op_class is OpClass.MEMORY_LOAD
    assert load.bytes_read == pytest.approx(4 * SHARED_BYTE_SCALE)
    assert load.flops == 0
    assert store.op_class is OpClass.MEMORY_STORE
    assert store.bytes_written == pytest.approx(8 * SHARED_BYTE_SCALE)
    copies = [i for i in instrs if i.opcode.startswith("cp.async.cg")]
    assert all(i.bytes_read == 16 for i in copies)  # device memory: unscaled
    wait = next(i for i in instrs if i.opcode == "cp.async.wait_group")
    assert instrs.index(wait) < instrs.index(load)
    an = analyze_module(module, "nvidia_h100_sxm")
    waits = [e for e in an.graph.edges if e.kind is EdgeKind.MEM_WAITCNT]
    assert {module.find(e.consumer).opcode for e in waits} == \
        {"cp.async.wait_group"}
    assert len({e.consumer for e in waits}) == 2


def test_shared_byte_scale_equals_the_reference():
    """The port keeps its own copy of the jaxpr front-end's VMEM scale."""
    assert SHARED_BYTE_SCALE == _VMEM_BYTE_SCALE


@pytest.mark.parametrize("store", ["st.global.v4.u32", "st.global.v4.b32"])
def test_16_byte_vectors_are_priced_at_16_bytes(store):
    """A 16-byte vector load or store moves 16 bytes a thread: from device
    memory at 16, from shared memory at 16 times SHARED_BYTE_SCALE; the
    store prices the same whether nvcc types it .u32 or .b32."""
    ring = _module(RING_V4.replace("st.global.v4.u32", store))
    sync = _module(SYNC_V4.replace("st.global.v4.u32", store))
    (shared, *_) = [i for i in ring.all_instructions()
                    if i.opcode == "ld.shared.v4.u32"]
    assert shared.op_class is OpClass.MEMORY_LOAD
    assert shared.bytes_read == pytest.approx(16 * SHARED_BYTE_SCALE)
    loads = [i for i in sync.all_instructions()
             if i.opcode == "ld.global.nc.v4.u32"]
    assert [i.bytes_read for i in loads] == [16.0, 16.0]
    for module in (ring, sync):
        stores = [i for i in module.all_instructions() if i.opcode == store]
        assert stores and all(i.op_class is OpClass.MEMORY_STORE and
                              i.bytes_written == 16.0 for i in stores)


@pytest.mark.parametrize("text,load", [(RING_V4, "ld.shared.v4.u32"),
                                       (SYNC_V4, "ld.global.nc.v4.u32")],
                         ids=["ring", "synchronous"])
def test_every_register_of_a_vector_load_links_to_it(text, load):
    """A brace-list destination defines each of its registers: the unpack
    of the first and of the last register, and the store of all four, all
    read the vector load; so does the bf16 conversion through the unpack."""
    module = _module(text)
    instrs = list(module.all_instructions())
    first = next(i for i in instrs if i.opcode == load)
    after = instrs[instrs.index(first) + 1:]
    unpack_first, unpack_last = [i for i in after
                                 if i.opcode == "mov.b32"][:2]
    assert first.name in unpack_first.operands
    assert first.name in unpack_last.operands
    store = next(i for i in after if i.opcode.startswith("st.global.v4"))
    assert first.name in store.operands
    cvt = next(i for i in after if i.opcode == "cvt.f32.bf16")
    assert cvt.operands == (unpack_first.name,)


def test_vector_ring_still_waits_on_its_groups():
    """The ring read as 16-byte vectors keeps the case study's edges: each
    `cp.async.wait_group 1` takes `mem_waitcnt` edges, and the vector read
    of the landed row comes after it."""
    module = _module(RING_V4)
    instrs = list(module.all_instructions())
    wait = next(i for i in instrs if i.opcode == "cp.async.wait_group")
    load = next(i for i in instrs if i.opcode == "ld.shared.v4.u32")
    assert instrs.index(wait) < instrs.index(load)
    an = analyze_module(module, "nvidia_h100_sxm")
    waits = [e for e in an.graph.edges if e.kind is EdgeKind.MEM_WAITCNT]
    assert {module.find(e.consumer).opcode for e in waits} == \
        {"cp.async.wait_group"}
    assert len({e.consumer for e in waits}) == 2


def test_synchronous_vector_loads_give_no_waitcnt_edges():
    """The baseline's 16-byte read-only loads are plain loads: no counter,
    no `mem_waitcnt` edge."""
    module = _module(SYNC_V4)
    assert not [i for i in module.all_instructions()
                if i.opcode.startswith("cp.async")]
    an = analyze_module(module, "nvidia_h100_sxm")
    assert not [e for e in an.graph.edges if e.kind is EdgeKind.MEM_WAITCNT]
