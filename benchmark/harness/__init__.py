"""The benchmark's yardstick: inputs from the seed, the app's window, the
device trace's reduction, the work counts and the output check."""
