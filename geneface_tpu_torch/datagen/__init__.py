"""Data generation (port of ``geneface_tpu/datagen``): from a person's video
frames and wav to the ``trainval_dataset.npy`` that head training reads —
face parsing (BiSeNet), landmarks (FAN), the 3DMM landmark track and its
photometric refinement on the soft-splat renderer (K1 and K8), 3DMM
coefficients (Deep3DRecon), the audio features and the binarizers — and
HuBERT (:mod:`~geneface_tpu_torch.datagen.wav2vec2`); the ASR conditions
(:mod:`~geneface_tpu_torch.datagen.asr_features`: DeepSpeech from a frozen
``.pb``, the esperanto wav2vec2) and the streaming ASR
(:mod:`~geneface_tpu_torch.datagen.streaming_asr`).

Only the tracker and the renderer run without weights; BiSeNet, FAN and
ReconNet read converted ``.npz`` weights (none are in the repository).
"""

from geneface_tpu_torch.datagen.face_recon import (  # noqa: F401
    Reconstructor,
    align_img,
    extract_5p,
    split_coeff,
)
from geneface_tpu_torch.datagen.face_tracker import (  # noqa: F401
    FaceBasis,
    fit_sequence,
    project_landmarks,
)


def extract_3dmm_coeffs(frames, landmarks, reconstructor=None, batch_size=32):
    """Per-frame 257-D BFM coefficients of uint8 frames and their 68-point
    landmarks → [T, 257] float32, in batches of ``batch_size`` through
    ``Reconstructor.recon_coeff`` (a default :class:`Reconstructor` on the
    card without one)."""
    import numpy as np

    recon = reconstructor or Reconstructor()
    out = []
    for lo in range(0, len(frames), batch_size):
        hi = min(lo + batch_size, len(frames))
        coeff, _ = recon.recon_coeff(np.asarray(frames[lo:hi]), np.asarray(landmarks[lo:hi]),
                                     return_image=False)
        out.append(coeff)
    return np.concatenate(out, axis=0)
