"""One module a loop: `loops/<loop>.py`, found by the `loop` that a mix file
names, with `run(args, cell, cfg, mix, man, tmp, device, t_start)` returning
(attempted, failed, metrics, device extras, breakdown, readings); readings
are {item: {number: value}}, judged against the cell's limits by run.py."""
