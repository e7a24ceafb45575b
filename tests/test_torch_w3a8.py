"""K5's W3A8 modes against the JAX kernel in interpret mode, on the CPU: the
cases of `tests/torch_sub4_a8.py` (which states the tolerance) at 3 bits."""
import pytest

import torch_sub4_a8 as cases

BITS = 3


@pytest.mark.parametrize("K,groupsize,name", cases.CASES)
def test_w3a8_matches_jax_interpret(K, groupsize, name):
    cases.matches_jax_interpret(BITS, K, groupsize, name)


@pytest.mark.parametrize("K,groupsize,name", cases.HIGH_CASES)
def test_w3a8_above_64_rows_matches_jax_interpret(K, groupsize, name):
    cases.above_64_rows_matches_jax_interpret(BITS, K, groupsize, name)


def test_exact_route_is_not_w3a8():
    cases.exact_route_is_not_a8(BITS)


@pytest.mark.parametrize("unpack", ["bf16"])
def test_exact_names_keep_the_exact_route(unpack):
    cases.exact_names_keep_the_exact_route(BITS, unpack)


@pytest.mark.parametrize("unpack,match", [("int8dot_diag_noand", "DIAGNOSTIC ONLY"),
                                          ("int8dot_bias", "unknown unpack"),
                                          ("INT8DOT", "unknown unpack"),
                                          ("bf16_groupdeq", "int2-only"),
                                          ("bf16_u8", "unknown unpack")])
def test_refused_names(unpack, match):
    cases.refused_names(BITS, unpack, match)


def test_w3a8_zero_rows():
    cases.zero_rows(BITS)


def test_w3a8_out_dtype_and_leading_dims():
    cases.out_dtype_and_leading_dims(BITS)


@pytest.mark.parametrize("K,Kp,G,M", cases.PLANS)
def test_sub4_a8_plan_is_the_jax_plan(K, Kp, G, M):
    cases.plan_is_the_jax_plan(BITS, K, Kp, G, M)


def test_plan_refusals():
    cases.plan_refusals(BITS)


@pytest.mark.parametrize("M,K,Kp,n,G", cases.EMULATED)
def test_kernel_emulation_matches_plain_version(M, K, Kp, n, G):
    cases.kernel_emulation_matches_plain_version(BITS, M, K, Kp, n, G)


@pytest.mark.parametrize("M,K,Kp,n,G", [(1, 4096, 4096, 4096, 1), (1, 11008, 11264, 4096, 1),
                                        (65, 780, 784, 2340, 1), (17, 780, 832, 2340, 13)])
def test_w3a8_launch_plan(M, K, Kp, n, G):
    cases.launch_plan(BITS, M, K, Kp, n, G)
