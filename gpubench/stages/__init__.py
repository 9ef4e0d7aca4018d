"""One module per stage the port runs. Each gives:

- ``UNIT``: what the stage's rate counts;
- ``write_inputs(data, config, params, workdir) -> dict``: the files a user
  hands the stage, for the window and for the warm-up slice;
- ``argv(files, config, out, warm) -> list[str]``: the subcommand's
  arguments;
- ``units(data) -> int``: units per invocation;
- ``summary(data, config) -> dict``: sizes the metric readers need;
- ``check(data, config, params, outputs, device, seed, control=None)
  -> (verdict, info)``: the verdict holds each compared number as
  ``{"value": v, "limit": l}``, and the run is correct when every value is
  at most its limit; info holds what the check looked at. ``control`` names
  a reference of a lower guarantee to judge in the program's place.
"""
