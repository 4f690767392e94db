"""The benchmark's plain reference of the sweep: the simulator written out
in plain PyTorch (:mod:`.sim`), its PRNG (:mod:`.prng`) and the replay of a
sample of instances from the seed (:mod:`.replay`). Frozen with the
benchmark; imports nothing of the program."""
