"""The benchmark's harness: manifest lookup, the traffic generator, the
cell's run, the device trace and the frozen yardsticks."""
