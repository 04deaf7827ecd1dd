// The CPU stand-in's pipeline primitives are in cuda_runtime.h.
#pragma once
#include "cuda_runtime.h"
