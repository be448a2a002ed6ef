"""The benchmark harness of ``bayes_sim_ig_tpu_torch``: it finds a cell's
files by name (``spec``), drives the port's loop over a measured window
(``loops``), taps the loop from outside for spans and for the values the
check compares (``taps``), reads a profiler slice (``trace``), counts
work from shapes (``counts``), compares against the plain reference
(``checks``) and prints the result line (``result``).

It imports the port only inside the functions that drive it, and never
the JAX package.
"""
