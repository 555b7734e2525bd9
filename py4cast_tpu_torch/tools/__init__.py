"""The user tools (each runs with ``python -m py4cast_tpu_torch.tools.<name>``).

Over finished runs:

- ``scores_comparison`` plots several runs' test scores;
- ``gif_comparison`` renders their forecasts of one case side by side.

Making weights and files the models and the exports read:

- ``pretrain_encoder`` trains the ResNet encoder (resnet18 or resnet34)
  self-supervised and writes the encoder npz ``encoder_weights`` loads;
- ``train_perceptual_features`` trains the perceptual loss's feature
  extractor (``data/perceptual_feats.npz``);
- ``convert_torchvision_encoder`` turns a torchvision ResNet checkpoint
  into an encoder npz (``encoder_norm: affine``);
- ``make_grib_template`` writes a GRIB template for a dataset's grid;
- ``host_memory_check`` is the data loader's RSS leak canary.

The tools that compute take ``--device`` (``cuda``, the default, raises
without a card; ``cpu`` on the CPU).
"""
