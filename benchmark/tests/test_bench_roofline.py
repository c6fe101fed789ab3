"""The roofline's peaks and work counts against shapes worked by hand."""

from __future__ import annotations

import pytest

from benchmark import roofline


def test_peaks_are_the_h100_sxm_data_sheet():
    assert roofline.PEAK_BYTES == 3.35e12
    assert roofline.PEAK_OPS == {"f32": 67e12, "tf32": 495e12, "bf16": 989e12,
                                 "int8": 1979e12}


def test_bound_takes_the_larger_time():
    assert roofline.bound(3.35e12, 1.0, "f32") == (1.0, "bytes")
    assert roofline.bound(1.0, 989e12, "bf16") == (1.0, "operations")


def test_flat_search_at_msmarco():
    # 8,841,823 one-byte codes of m=24; 128 queries' f32 tables of 24 x 256;
    # 128 x 100 answers of 12 bytes; 128 x 8,841,823 x 24 additions.
    nbytes, ops = roofline.adc_flat_work(8_841_823, 128, 24, 256, 100)
    assert nbytes == 8_841_823 * 24 + 128 * 24 * 256 * 4 + 128 * 100 * 12
    assert nbytes == 212_203_752 + 3_145_728 + 153_600
    assert ops == 27_162_080_256
    t, by = roofline.bound(nbytes, ops, "f32")
    assert by == "operations" and t == pytest.approx(405.39e-6, rel=1e-4)


def test_ivf_search_counts_the_union_once_and_each_querys_pairs():
    # 1,600 cells of 2,441 rows in the union; 64 queries x 32 cells x 2,441.
    union, pairs = 1_600 * 2_441, 64 * 32 * 2_441
    nbytes, ops = roofline.adc_ivf_work(union, pairs, 64, 16, 256, 10)
    assert nbytes == 3_905_600 * 16 + 64 * 16 * 256 * 4 + 64 * 10 * 12
    assert ops == 4_999_168 * 16
    assert roofline.bound(nbytes, ops, "f32")[1] == "bytes"


def test_encode_of_a_million_rows_at_768():
    nbytes, ops = roofline.encode_work(1 << 20, 768, 24, 256)
    assert nbytes == (1 << 20) * 768 * 4 + (1 << 20) * 24 + 256 * 768 * 4
    assert ops == 2 * (1 << 20) * 256 * 768
    t, by = roofline.bound(nbytes, ops, "bf16")
    assert by == "bytes" and t == pytest.approx(0.9690e-3, rel=1e-3)


def test_a_code_that_names_no_centroid_has_an_infinite_gap():
    import torch

    from benchmark.reference import vq

    cb = torch.randn(2, 4, 3)
    r = torch.randn(5, 6)
    codes = vq.encode_lowp(cb, r, torch.float32)
    assert vq.code_gap(cb, r, codes) < 1e-6
    codes[2, 1] = 4
    assert vq.code_gap(cb, r, codes) == float("inf")
