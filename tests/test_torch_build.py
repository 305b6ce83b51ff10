"""The port's kernel build: a library's name carries a hash of its
source and of every ``nvcc`` flag it is built with, its own flags
included, so a changed flag builds a new library and never loads a
stale one.  No compiler is run."""
from pathlib import Path

from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.fedavg import fedavg
from repro_torch.kernels.flash_attention.flash_attention import (
    LIB as FA_LIB, LIB_MMA, LIB_SM90, LIB_TF32X3, LIBS as FA_LIBS)


def test_a_changed_extra_flag_changes_the_library_path(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("extern \"C\" int f() { return 0; }\n")
    plain = CudaLibrary(src, "k", {})
    linked = CudaLibrary(src, "k", {}, extra_flags=("-lcuda",))
    other = CudaLibrary(src, "k", {}, extra_flags=("-lcuda", "-I/x"))
    paths = {plain.path(), linked.path(), other.path()}
    assert len(paths) == 3
    assert all(p.name.startswith("libk-") for p in paths)
    # the same source and flags: the same library, built once
    assert CudaLibrary(src, "k", {}, extra_flags=["-lcuda"]).path() == \
        linked.path()
    src.write_text("extern \"C\" int f() { return 1; }\n")
    assert linked.path() not in paths


def test_no_extra_flags_keep_the_name_a_library_had_without_them():
    lib = fedavg.LIB
    assert lib.extra_flags == ()
    assert CudaLibrary(lib.src, lib.name, {}).path() == lib.path()


def test_the_tensor_core_flash_source_links_libcuda():
    """cuTensorMapEncodeTiled is libcuda's: the sm90 source is built
    with -lcuda, and every flash source sits beside its wrapper."""
    assert "-lcuda" in LIB_SM90.extra_flags
    for lib in FA_LIBS:
        assert isinstance(lib.src, Path) and lib.src.is_file()
    assert LIB_SM90.path() != FA_LIB.path()


def test_the_four_flash_sources_are_built_each_into_its_own_library():
    """The mma.sync source is built with the others at first use (and by
    ``chip_smoke.py``'s phase 2, from ``LIBS``): plain flags, a library
    of its own."""
    assert set(FA_LIBS) == {LIB_SM90, LIB_TF32X3, LIB_MMA, FA_LIB}
    assert LIB_MMA.extra_flags == ()
    assert LIB_MMA.src.name == "flash_attention_mma.cu"
    assert len({lib.path() for lib in FA_LIBS}) == 4
    assert LIB_MMA.path().name.startswith("libflash_attention_mma-")
