"""The entry points a cell can drive, one file each, found by the mix's
``call`` key. Each file defines ``Call(config, traffic, seed, device)``:

- ``sizes``: the matrix orders its calls factor;
- ``warm()``: set-up: every input the window uses, called and its info
  read;
- ``run(i)``: the window's call i: (answer a check may keep or None, info
  as a 0-d tensor that the caller reads);
- ``flops(i)``: the benchmark's operation count of call i;
- ``control(kept)``: the answers of the calls in ``kept`` as the
  reference gives them in TF32, the control put in the program's place;
- ``numbers(kept)``: the numbers compared, from the kept answers (a
  training call compares the steps it took in set-up instead).
"""
