"""One Adam step of one parameter leaf, in place: the clip's scale, the two
moments, the bias corrections, the decoupled weight decay and the apply,
skipped as a whole where the step's guard flag is false."""
