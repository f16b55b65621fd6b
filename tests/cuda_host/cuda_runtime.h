// Host stand-in for <cuda_runtime.h>: see emulation.h.
#pragma once
#include "emulation.h"
