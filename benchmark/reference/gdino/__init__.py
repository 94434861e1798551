"""Plain reference of GroundingDINO SwinT-OGC (IDEA-Research, Liu et al.,
arXiv:2303.05499; the published ``GroundingDINO_SwinT_OGC.py``) for the
benchmark's ``correct``: plain ``torch`` in float32, with TF32 off where it
runs, and nothing of the port or JAX imported.

- ``swin.py``: Swin-T with plain window attention (a softmax over each
  window's logits plus the relative-position bias and the shift mask).
- ``text.py``: BERT-base as einsums, the hash tokenizer and the
  sub-sentence masks of the phrases.
- ``model.py``: the feature enhancer (bi-directional image-text fusion as
  einsums, text self-attention, deformable self-attention), the top-900
  language-guided query selection by a stable sort, the cross-modality
  decoder with shared-head box refinement, the contrastive head, and the
  image preprocessing. Deformable sampling is upstream's
  ``multi_scale_deformable_attn_pytorch``: ``F.grid_sample``, bilinear,
  zero padding, ``align_corners=False``, taken in blocks of queries.

Departures from upstream, each also the port's:

- Parameter names are those of the HF ``GroundingDinoForObjectDetection``
  checkpoint; one head (``bbox_embed.0``) serves every decoder layer
  (``dec_pred_bbox_embed_share``).
- Swin's layer norms and the level projections' group norms take
  epsilon 1e-6 and the patch embedding pads as a "SAME" convolution (the
  JAX package's conventions); a level at or below the window size runs as
  one unshifted window, and the relative-position tables are sized for the
  800 x 800 canvas (7 x 7 windows at every stage).
- The image rides on a fixed padded canvas (800 x 1333 for a landscape
  frame) with a pixel mask; it is resized with a triangle filter that
  widens only where it downscales.
- Text comes from a hash tokenizer (no BERT vocabulary is on disk); its
  begin and end ids are the special tokens of upstream's sub-sentence
  mask rule (so a text closed by its end id keeps the identity mask), and
  texts of a batch are padded after their masks are made. A chunk of
  texts is padded to a multiple of 4 rows by repeating its first.
- Fusion attention subtracts the global maximum over the batch (as
  upstream does) before the +-50000 clamp.
- ``forward(..., topk=...)`` takes the query selection's indices from the
  caller, so the decoder can run on the queries another implementation
  chose; the reference's own selection and its scores come back beside
  them.
"""
