"""Operations and bytes of the port's kernels and of the whole model.

``kernels``: frozen copies of the cost functions of ``chip_smoke.py``
(``stage_cost``, ``stack_cost``, ``_layer_flops``, ``msd_passes``,
``conv_cost``, ``bound_ms``) with the H100 peaks, plus the shapes a cell's
calls take, worked out from the configuration. ``model_flops``: the model's
FLOP per request or step, counted by ``torch.utils.flop_counter`` over the
plain reference on meta tensors, whatever implements the work.
"""
