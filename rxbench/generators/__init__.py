"""Signal generators, one a file, found by the name a traffic mix gives.
Each has ``make_ring(geo, spec, gen, dial_hz) -> (steps * samples_per_step,
channels) complex64`` host array, made on the device of the torch
generator ``gen`` seeded from the run's seed."""
