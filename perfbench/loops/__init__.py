"""Loop kinds, one module each, named by a traffic file's ``loop``: each
has ``run(cell, seed, seconds, trace, device, t_start) -> Outcome``."""
