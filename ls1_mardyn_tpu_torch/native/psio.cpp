// Fast phase-space record I/O.
//
// Native counterpart of the reference's C++ stream readers/writers
// (src/io/ASCIIReader.cpp:283-383 record loop,
// CheckpointWriter): parsing 4M+ molecule records through Python
// tokenization costs minutes; this strtod-based scanner does it at
// ~100 MB/s.  Exposed through a minimal C ABI consumed via ctypes
// (no pybind11 dependency).
//
// Record layouts (doubles per record):
//   ICRVQDV: id cid r(3) v(3) q(4) D(3) Vi(3)  -> 18
//   ICRVQD:  id cid r(3) v(3) q(4) D(3)        -> 15
//   ICRV:    id cid r(3) v(3)                  -> 8
//   IRV:     id r(3) v(3)                      -> 7

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cerrno>

extern "C" {

// Parse n_records * n_cols whitespace-separated doubles starting at
// byte `offset` of `path` into `out`.  Returns the number of doubles
// parsed (== n_records*n_cols on success), or -1 on I/O error.
long psio_read_records(const char* path, long offset, long n_records,
                       int n_cols, double* out) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return -1; }
    long size = ftell(f);
    if (offset < 0 || offset > size) { fclose(f); return -1; }
    long len = size - offset;
    char* buf = (char*)malloc(len + 1);
    if (!buf) { fclose(f); return -1; }
    if (fseek(f, offset, SEEK_SET) != 0 ||
        (long)fread(buf, 1, len, f) != len) {
        free(buf); fclose(f); return -1;
    }
    fclose(f);
    buf[len] = '\0';

    const long total = n_records * (long)n_cols;
    char* p = buf;
    long parsed = 0;
    while (parsed < total) {
        char* end = nullptr;
        errno = 0;
        double v = strtod(p, &end);
        if (end == p) break;  // no more numbers
        out[parsed++] = v;
        p = end;
    }
    free(buf);
    return parsed;
}

// Append n_records * n_cols doubles as one whitespace-separated record
// per line (full %.17g precision).  Returns 0 on success.
int psio_write_records(const char* path, long n_records, int n_cols,
                       const double* data, const long* int_cols,
                       int n_int_cols) {
    FILE* f = fopen(path, "ab");
    if (!f) return -1;
    char line[1024];
    for (long r = 0; r < n_records; ++r) {
        int pos = 0;
        for (int c = 0; c < n_cols; ++c) {
            double v = data[r * n_cols + c];
            bool is_int = false;
            for (int k = 0; k < n_int_cols; ++k)
                if (int_cols[k] == c) { is_int = true; break; }
            if (is_int)
                pos += snprintf(line + pos, sizeof(line) - pos, "%ld",
                                (long)v);
            else
                pos += snprintf(line + pos, sizeof(line) - pos, "%.17g", v);
            line[pos++] = (c + 1 == n_cols) ? '\n' : '\t';
        }
        if (fwrite(line, 1, pos, f) != (size_t)pos) { fclose(f); return -1; }
    }
    fclose(f);
    return 0;
}

}  // extern "C"
