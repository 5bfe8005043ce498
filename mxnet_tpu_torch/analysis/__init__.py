"""The static analyses (``mxnet_tpu/analysis``).  Only the finding and
report types of :mod:`.core` are ported so far, for the quantization
emission report; the passes come with ROADMAP item 10."""
