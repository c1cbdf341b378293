"""The benchmark's four synthetic families (portbench/traffic_gen.py), held
to SHA-256 digests of their float32 bytes. The digests were taken from the
copy chip_smoke.py kept before it came to import the families from the
benchmark, so the work every run carries stays pinned."""

import hashlib

import pytest

from portbench import traffic_gen

DIGESTS = {
    4000: "c7e73f6977e7e502aed1ea39a4139ffd936b7c74af1d525336b9e5dc1e89bc91",
    16001: "349f60b5b3295f4573bb4c848a1893bfc276cc690c077c9dadcc42dcd5902062",
}


@pytest.mark.parametrize("L", sorted(DIGESTS))
def test_families_keep_their_digest(L):
    fam = traffic_gen.families(L, 16000)
    assert fam.shape == (4, L) and fam.dtype == "float32"
    assert hashlib.sha256(fam.tobytes()).hexdigest() == DIGESTS[L]
