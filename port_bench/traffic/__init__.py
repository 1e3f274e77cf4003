"""Traffic: mixes as data files, one general length generator, four drivers.

``<mix>.json`` holds a mix's parameters and names its driver. ``lengths.py``
turns a mix's utterance parameters into frame counts; each driver
(``serve_closed``, ``batch_offline``, ``train_steps``, ``stream_lockstep``)
sets the program up for a cell, runs its measured window and checks what the
window produced against the reference.
"""
