"""The port's visualise CLI (python -m vqvae_wavenet_torch.visualise)
against the root visualise.py, which reads the speaker tables through the
JAX package: on the same .npy files (a 512 x 64 codebook and a 109 x 64
speaker table, random from a numpy seed) and the repo's VCTK tables, the
four TSV files are equal byte for byte."""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import visualise as root_cli  # noqa: E402
from vqvae_wavenet_torch import visualise as port_cli  # noqa: E402


def test_tsv_files_equal_the_root_cli_byte_for_byte(tmp_path):
    rng = np.random.default_rng(0)
    emb = tmp_path / "embedding_6.npy"
    spk = tmp_path / "speaker_embedding_6.npy"
    np.save(emb, rng.standard_normal((512, 64)).astype(np.float32))
    np.save(spk, rng.standard_normal((109, 64)).astype(np.float32))
    outs = {}
    for name, cli in (("root", root_cli), ("port", port_cli)):
        save = tmp_path / name
        cli.main(["-embedding", str(emb), "-speaker", str(spk), "-dataset",
                  "VCTK", "-save", str(save), "-data",
                  os.path.join(REPO, "data")])
        outs[name] = {f: (save / f).read_bytes()
                      for f in sorted(os.listdir(save))}
    assert sorted(outs["port"]) == [
        "embedding_6_meta.tsv", "embedding_6_vecs.tsv",
        "speaker_embedding_6_meta.tsv", "speaker_embedding_6_vecs.tsv"]
    assert outs["port"] == outs["root"]
    meta = outs["port"]["speaker_embedding_6_meta.tsv"].decode().split("\n")
    assert len(meta) == 110 and "#" in meta[0]
