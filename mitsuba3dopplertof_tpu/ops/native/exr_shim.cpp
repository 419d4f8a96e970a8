// Minimal C ABI shim over libOpenEXR for the renderer's Bitmap layer.
// Equivalent role to the reference's EXR path in src/core/bitmap.cpp (which
// links OpenEXR directly); exposed to Python via ctypes.
#include <ImfInputFile.h>
#include <ImfOutputFile.h>
#include <ImfChannelList.h>
#include <ImfFrameBuffer.h>
#include <ImfHeader.h>
#include <ImathBox.h>
#include <half.h>
#include <cstring>
#include <string>
#include <vector>

using namespace Imf;
using namespace Imath;

extern "C" {

// Reads up to 4 channels (R,G,B,A order if present, else file order) as f32.
// Returns 0 on success. Caller frees *out with exr_free.
int exr_read(const char* path, float** out, int* width, int* height,
             int* n_channels, char* channel_names, int channel_names_cap) {
    try {
        InputFile file(path);
        Box2i dw = file.header().dataWindow();
        int W = dw.max.x - dw.min.x + 1;
        int H = dw.max.y - dw.min.y + 1;

        const ChannelList& chl = file.header().channels();
        std::vector<std::string> names;
        const char* pref[] = {"R", "G", "B", "A", "W", "Y"};
        for (const char* p : pref)
            if (chl.findChannel(p)) names.push_back(p);
        // remaining channels (AOVs: S0.R.., depth, variance moments, ...)
        // in file order after the preferred base layout
        for (auto it = chl.begin(); it != chl.end(); ++it) {
            bool seen = false;
            for (const auto& n : names) seen |= (n == it.name());
            if (!seen) names.push_back(it.name());
        }
        int C = (int)names.size();
        if (C > 64) C = 64;

        float* buf = new float[(size_t)W * H * C];
        FrameBuffer fb;
        for (int c = 0; c < C; ++c) {
            fb.insert(names[c],
                      Slice(FLOAT,
                            (char*)(buf + c) - (dw.min.x + (size_t)dw.min.y * W) * C * sizeof(float),
                            sizeof(float) * C, sizeof(float) * C * W));
        }
        file.setFrameBuffer(fb);
        file.readPixels(dw.min.y, dw.max.y);

        *out = buf;
        *width = W;
        *height = H;
        *n_channels = C;
        if (channel_names && channel_names_cap > 0) {
            std::string joined;
            for (int c = 0; c < C; ++c) {
                if (c) joined += ",";
                joined += names[c];
            }
            std::strncpy(channel_names, joined.c_str(), channel_names_cap - 1);
            channel_names[channel_names_cap - 1] = 0;
        }
        return 0;
    } catch (...) {
        return 1;
    }
}

void exr_free(float* p) { delete[] p; }

// Writes C channels interleaved f32 data; names comma-separated. half=1
// stores HALF (the reference hdrfilm default component_format float16).
int exr_write(const char* path, const float* data, int W, int H, int C,
              const char* names_csv, int store_half) {
    try {
        std::vector<std::string> names;
        {
            std::string s(names_csv);
            size_t pos = 0;
            while (pos != std::string::npos && names.size() < (size_t)C) {
                size_t e = s.find(',', pos);
                names.push_back(s.substr(pos, e == std::string::npos ? e : e - pos));
                pos = (e == std::string::npos) ? e : e + 1;
            }
        }
        while ((int)names.size() < C) names.push_back("ch" + std::to_string(names.size()));

        Header header(W, H);
        header.compression() = PIZ_COMPRESSION;
        std::vector<Imath::half> hbuf;
        FrameBuffer fb;
        if (store_half) {
            hbuf.resize((size_t)W * H * C);
            for (size_t i = 0; i < hbuf.size(); ++i) hbuf[i] = data[i];
            for (int c = 0; c < C; ++c) {
                header.channels().insert(names[c], Channel(HALF));
                fb.insert(names[c], Slice(HALF, (char*)(hbuf.data() + c),
                                          sizeof(::half) * C, sizeof(::half) * C * W));
            }
        } else {
            for (int c = 0; c < C; ++c) {
                header.channels().insert(names[c], Channel(FLOAT));
                fb.insert(names[c], Slice(FLOAT, (char*)(data + c),
                                          sizeof(float) * C, sizeof(float) * C * W));
            }
        }
        OutputFile file(path, header);
        file.setFrameBuffer(fb);
        file.writePixels(H);
        return 0;
    } catch (...) {
        return 1;
    }
}

}  // extern "C"
