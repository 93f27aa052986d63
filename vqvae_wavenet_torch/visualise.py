"""Visualisation CLI of the port (the root visualise.py's flags and
output, without the JAX package):

    python -m vqvae_wavenet_torch.visualise -embedding embedding_N.npy \
        -speaker speaker_embedding_N.npy -dataset VCTK -save viz -data data/

Dumps codebook / speaker-embedding .npy files as TSV vec+meta pairs for
projector.tensorflow.org; speaker metadata joins <corpus>_speaker_info.txt
(gender/accent).  Output FORMAT matches the reference byte-for-byte (vecs =
tab-joined floats, meta = 1-based code index or '#'-joined speaker info);
the speaker tables are read by vqvae_wavenet_torch/data.py.
"""
import argparse
import os

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-embedding", dest="embedding",
                        help="embedding space")
    parser.add_argument("-speaker", dest="speaker",
                        help="speaker embedding space")
    parser.add_argument("-dataset", default="VCTK", dest="dataset",
                        help="VCTK or LibriSpeech")
    parser.add_argument("-save", dest="save", help="save to folder")
    parser.add_argument("-data", default="data/", dest="data_path",
                        metavar="str", help="dataset root (speaker files)")
    return parser.parse_args(argv)


def write_projector_tsv(npy_path: str, save_dir: str, labels) -> str:
    """Write <stem>_vecs.tsv / <stem>_meta.tsv for one embedding matrix.

    labels: sequence of meta strings, one per embedding row (padded with
    'missing_info' if shorter than the matrix).  Returns the stem.
    """
    emb = np.load(npy_path)
    stem = os.path.basename(npy_path)
    stem = stem[:-4] if stem.endswith(".npy") else stem
    vec_lines = ["\t".join(str(x) for x in row) for row in emb]
    meta_lines = [labels[i] if i < len(labels) else "missing_info"
                  for i in range(len(emb))]
    with open(os.path.join(save_dir, f"{stem}_vecs.tsv"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(vec_lines) + "\n")
    with open(os.path.join(save_dir, f"{stem}_meta.tsv"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(meta_lines) + "\n")
    return stem


def speaker_labels(dataset: str, data_path: str):
    """Per-speaker '#'-joined gender/accent labels ordered by speaker id."""
    from vqvae_wavenet_torch.data import get_speaker_info, get_speaker_to_int

    locations = {"VCTK": ("vctk_speakers.txt", "vctk_speaker_info.txt",
                          "vctk_info"),
                 "LibriSpeech": ("librispeech_speakers.txt",
                                 "librispeech_speaker_info.txt",
                                 "librispeech_info")}
    if dataset not in locations:
        raise NotImplementedError(f"dataset {dataset}")
    speakers_name, info_name, sub = locations[dataset]

    def find(name):
        for cand in (os.path.join(data_path, name),
                     os.path.join(data_path, sub, name)):
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(f"{name} under {data_path}")

    speaker_to_int = get_speaker_to_int(find(speakers_name))
    info = get_speaker_info(speaker_to_int, find(info_name))
    return [info[i] for i in range(len(speaker_to_int))]


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.save, exist_ok=True)

    if args.embedding:
        n_codes = len(np.load(args.embedding))
        write_projector_tsv(args.embedding, args.save,
                            [str(i + 1) for i in range(n_codes)])
    if args.speaker:
        write_projector_tsv(args.speaker, args.save,
                            speaker_labels(args.dataset, args.data_path))
    print("upload to http://projector.tensorflow.org")


if __name__ == "__main__":
    main()
