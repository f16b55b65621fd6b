// Host stand-in for <cuda_bf16.h>: see emulation.h.
#pragma once
#include "emulation.h"
