"""PyTorch port, kernel build: paddle_tpu_torch.ops.kernels._build names each
library by a hash of what goes into it, so an edited source or header is
rebuilt and a stale library is never loaded. No nvcc is needed here."""
from paddle_tpu_torch.ops.kernels import _build


def _tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "tile.cuh"\n')
    (csrc / "tile.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return csrc


def test_target_hash_covers_headers(tmp_path, monkeypatch):
    csrc = _tree(tmp_path, monkeypatch)
    src = csrc / "k.cu"
    first = _build._target(src)
    assert first == _build._target(src)
    (csrc / "tile.cuh").write_text("// v2\n")
    second = _build._target(src)
    assert second != first
    (csrc / "extra.cuh").write_text("// new header\n")
    assert _build._target(src) != second


def test_headers_are_not_sources(tmp_path, monkeypatch):
    csrc = _tree(tmp_path, monkeypatch)
    assert [s.name for s in _build.sources()] == ["k.cu"]
    assert [h.name for h in _build.headers()] == ["tile.cuh"]
    src = csrc / "k.cu"
    before = _build._target(src)
    src.write_text('#include "tile.cuh"\n// edited\n')
    assert _build._target(src) != before


def test_port_headers_listed():
    assert "mma_tile.cuh" in [h.name for h in _build.headers()]


def test_flash_variants_apply_to_the_sources():
    """Every timed variant of the flash kernels still matches the
    sources it edits (each substitution exactly once), and base is the
    sources as they are."""
    from paddle_tpu_torch.ops.kernels import flash_variants as fv
    base = fv.variant_sources("base")
    assert base[fv.CU] == (_build.CSRC_DIR / fv.CU).read_text()
    for name in fv.VARIANTS:
        texts = fv.variant_sources(name)
        assert set(texts) == {fv.CU, fv.H}
        if name != "base":
            assert texts != base, name


def test_zero_variants_apply_to_the_source():
    """Every timed variant of the fused Adam update B8 still matches
    csrc/zero_update.cu (each substitution exactly once), and zero_base is
    the source as it is."""
    from paddle_tpu_torch.ops.kernels import flash_variants as fv
    base = fv.variant_sources("zero_base")
    assert base == {fv.ZU: (_build.CSRC_DIR / fv.ZU).read_text()}
    for name in fv.ZERO_VARIANTS:
        texts = fv.variant_sources(name)
        assert set(texts) == {fv.ZU}
        if name != "zero_base":
            assert texts != base, name


def test_paged_variants_apply_to_the_source():
    """Every timed variant of the paged decode kernels B4/B5 (chunk length,
    rows in flight) still matches csrc/paged_attention.cu (each
    substitution exactly once), and paged_base is the source as it is."""
    from paddle_tpu_torch.ops.kernels import flash_variants as fv
    base = fv.variant_sources("paged_base")
    assert base == {fv.PA: (_build.CSRC_DIR / fv.PA).read_text()}
    for name in fv.PAGED_VARIANTS:
        texts = fv.variant_sources(name)
        assert set(texts) == {fv.PA}
        if name != "paged_base":
            assert texts != base, name
    assert set(fv.ALL_VARIANTS) == (set(fv.VARIANTS) | set(fv.ZERO_VARIANTS)
                                    | set(fv.PAGED_VARIANTS))
