// timg-tpu-torch-fast: pure-C one-shot launcher of the port
// (timg_tpu_torch), a copy of timg_tpu/native/timg_fast_main.cc with
// these changes:
//
//   * it execs ./timg-tpu-torch, the port's python launcher, on a bail;
//   * it renders on the host only when the caller asks for the CPU
//     (TIMG_TPU_TORCH_DEVICE=cpu): with any other device it hands the
//     invocation to the resident server, else execs the python launcher,
//     so a still on the card's host runs on the card;
//   * its server client uses the port's socket (timg-tpu-torch.sock) and
//     the port's checks: it sends nothing to a path that is not a socket
//     of its own uid, or to a listener of another uid (SO_PEERCRED);
//   * deflate (the kitty/iTerm2 PNG writer, the PNG decoder) resolves at
//     run time in timg_still.cc, so the build needs neither libdeflate.h
//     nor zlib.h; where jpeglib.h is absent the JPEG decoder is left out
//     and a JPEG execs the python launcher, whose fast path decodes it
//     through PIL.
//
// The python fastpath (fast.py) already renders one-shot stills
// through the native pipeline, but pays ~20 ms of interpreter boot plus
// ~55 ms of stdlib/ctypes imports per invocation -- the reference binary
// does the whole job in ~10 ms (BASELINE.md config #1).  This binary is
// the same envelope with zero python: argument parsing, terminal
// queries, PNG-still decode, scale/compose/blocks/sixel/kitty/iTerm2
// emission all run natively (linking the same timg_still.cc /
// timg_native.cc pipeline the python fastpath calls through ctypes), and
// ANYTHING outside the envelope execs the tracked python launcher
// (./timg-tpu-torch), which retries its own wider fastpath (PIL stills)
// before handing to the full session path.
//
// Byte parity: for every invocation this binary commits to, the
// (stdout bytes, stderr text, exit code) triple is identical to
// fast.py's -- enforced by tests/test_torch_fastlauncher.py over the
// same option matrices as tests/test_torch_fastpath_cli.py.  The step
// order below deliberately mirrors fast.py::try_fast_main line-for-line;
// fast.py in turn mirrors cli.py and the reference (ref src/timg.cc:426-1005,
// src/term-query.cc, src/renderer.cc:46-76).

#include <errno.h>
#include <fcntl.h>
#include <limits.h>
#include <math.h>
#include <signal.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/ioctl.h>
#include <sys/select.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/un.h>
#include <sys/time.h>
#include <termios.h>
#include <time.h>
#include <unistd.h>

#include <new>
#include <string>
#include <vector>
#include <memory>

#include "css3_colors.inc"

// ---------------------------------------------------------------------
// Pipeline entry points from timg_still.cc / timg_native.cc (the same
// symbols fast.py binds through ctypes).
// ---------------------------------------------------------------------
extern "C" {
void timg_buf_free(void *p);
long timg_png_decode(const uint8_t *buf, long len, uint8_t **out_rgba,
                     int *out_w, int *out_h, int *out_flags);
int timg_calc_scale(int img_width, int img_height, int width, int height,
                    int fill_width, int fill_height, double width_stretch,
                    int upscale, int upscale_integer, int cell_x_px,
                    int cell_y_px, int fit_in_rotated, int *out_w,
                    int *out_h);
int timg_build_taps(int in_size, int out_size, int horizontal,
                    int32_t **starts_out, float **coeffs_out);
int timg_plan_passes(int in_h, int in_w, int out_h, int out_w,
                     int alpha_weighted);
long timg_resize_polyphase(const uint8_t *in, int batch, int in_h, int in_w,
                           uint8_t *out, int out_h, int out_w,
                           const int32_t *starts_v, const float *coeffs_v,
                           int widest_v, const int32_t *starts_h,
                           const float *coeffs_h, int widest_h,
                           int vertical_first, int alpha_weighted);
long timg_png_decode_raw(const uint8_t *buf, long len, uint8_t **out_raw,
                         int *out_w, int *out_h, int *out_color,
                         int *out_flags);
long timg_resize_polyphase_src(const uint8_t *in, long in_pitch,
                               int src_rgb, int batch, int in_h, int in_w,
                               uint8_t *out, int out_h, int out_w,
                               const int32_t *starts_v,
                               const float *coeffs_v, int widest_v,
                               const int32_t *starts_h,
                               const float *coeffs_h, int widest_h,
                               int vertical_first, int alpha_weighted);
void timg_resize_nearest(const uint8_t *in, int in_h, int in_w, uint8_t *out,
                         int out_h, int out_w);
long timg_has_translucency(const uint8_t *rgba, long npixels);
void timg_alpha_over_bg(uint8_t *frame, int h, int w, const uint8_t *bg4,
                        const uint8_t *pat4, int pattern_w, int pattern_h,
                        int start_row);
void timg_quarter_blocks(const uint8_t *frame, int h, int w,
                         int use_upper_half_block, int32_t *glyph,
                         uint8_t *fg, uint8_t *bg);
void timg_half_blocks(const uint8_t *frame, int h, int w,
                      int use_upper_half_block, int32_t *glyph, uint8_t *fg,
                      uint8_t *bg);
long timg_ansi_emit(const int32_t *glyph, const uint8_t *fg,
                    const uint8_t *bg, const uint8_t *eq, int hcells,
                    int wcells, int indent, int use_256, char *out);
void timg_png_sub_filter(const uint8_t *rgba, int h, int w, int ch,
                         uint8_t *out);
long timg_sixel_encode(const uint8_t *indices, int h, int w, int pitch,
                       const uint8_t *palette, int n_colors, char *out);
int timg_libsixel_quant(const uint8_t *rgba, int h, int w, long pitch,
                        int reqcolors, uint8_t *out_pal, uint8_t *out_idx);
int timg_libsixel_palette(const uint8_t *rgba, int h, int w, long pitch,
                          int reqcolors, uint8_t *out_pal);
void timg_libsixel_build_table(const uint8_t *pal, int ncolors,
                               uint8_t *out_table);
int timg_libsixel_apply_table(const uint8_t *rgba, int h, int w,
                              long pitch, const uint8_t *table,
                              const uint8_t *pal, int diffuse,
                              uint8_t *out_idx);
uint32_t timg_crc32(uint32_t crc, const uint8_t *p, long n);
long timg_zlib_compress(const uint8_t *src, long n, int level,
                        uint8_t **out);
const char *timg_deflate_name(void);
}

// Exit codes (ref timg.cc:98-106).
enum {
    EXIT_OK = 0,
    EXIT_IMAGE_READ_ERROR = 1,
    EXIT_PARAMETER_ERROR = 2,
    EXIT_NOT_A_TERMINAL = 3,
    EXIT_CANT_OPEN_OUTPUT = 4,
    EXIT_FILELIST_PROBLEM = 5,
};

static volatile sig_atomic_t s_interrupted = 0;
static void sig_handler(int) { s_interrupted = 1; }

// TIMG_TPU_FAST_TIMING=1: per-stage wall times on stderr, the deflate
// library in use, and a "served" stage when the server answered
// (diagnostic only -- the python launcher has no equivalent, so parity
// tests never set it).
static bool s_timing = false;
static double now_ms() {
    struct timespec t;
    clock_gettime(CLOCK_MONOTONIC, &t);
    return t.tv_sec * 1e3 + t.tv_nsec * 1e-6;
}
static double now_s() {
    struct timespec t;
    clock_gettime(CLOCK_MONOTONIC, &t);
    return (double)t.tv_sec + t.tv_nsec * 1e-9;
}
static double s_t_last = 0;
static void stage(const char *name) {
    if (!s_timing) return;
    double t = now_ms();
    if (s_t_last != 0)
        fprintf(stderr, "[timing] %-12s %6.2f ms\n", name, t - s_t_last);
    s_t_last = t;
}

// ---------------------------------------------------------------------
// Fallback: exec the tracked python launcher with the original argv.
// The launcher (./timg-tpu-torch, shebang `env -S python3 -S`) retries the
// wider python fastpath (PIL-decoded stills) and then the full path --
// the exact chain a user without this binary gets.  Nothing has been
// written to the output fd when this runs.
// ---------------------------------------------------------------------
static int g_argc;
static char **g_argv;

// ---------------------------------------------------------------------
// Resident session client (timg-tpu-torch --serve, serve.py): when
// the serve socket exists, delegate the invocation to the warm python
// process instead of exec'ing a cold one -- the request ships our
// argv/cwd/env plus fds 0-2 over SCM_RIGHTS, so the served run talks
// to our tty directly (terminal queries, pagers, escape stream).
// Returns only when serving is unavailable or refused before any
// output could have been produced; on success it exits with the
// served exit code.
// ---------------------------------------------------------------------

static volatile int g_serve_fd = -1;
static void serve_forward_sigint(int) {
    const int fd = g_serve_fd;
    if (fd >= 0) {
        const ssize_t r = write(fd, "I\n", 2);
        (void)r;
    }
}

static void json_escape(std::string *out, const char *s) {
    for (const unsigned char *p = (const unsigned char *)s; *p; ++p) {
        const unsigned char c = *p;
        switch (c) {
        case '"': *out += "\\\""; break;
        case '\\': *out += "\\\\"; break;
        case '\n': *out += "\\n"; break;
        case '\r': *out += "\\r"; break;
        case '\t': *out += "\\t"; break;
        default:
            if (c < 0x20) {
                char b[8];
                snprintf(b, sizeof(b), "\\u%04x", c);
                *out += b;
            } else {
                *out += (char)c;
            }
        }
    }
}

static void try_serve() {
    if (getenv("TIMG_TPU_NO_SERVE")) return;
    std::string path;
    const char *env_sock = getenv("TIMG_TPU_SERVE_SOCKET");
    if (env_sock && *env_sock) {
        path = env_sock;
    } else {
        const char *xdg = getenv("XDG_RUNTIME_DIR");
        struct stat st;
        if (xdg && *xdg && stat(xdg, &st) == 0 && S_ISDIR(st.st_mode))
            path = std::string(xdg) + "/timg-tpu-torch.sock";
        else
            path = "/tmp/timg-tpu-torch-" + std::to_string(getuid()) +
                   ".sock";
    }
    // serve._ours: only a socket this user owns is sent the request (it
    // carries our environment and terminal)
    struct stat sst;
    if (lstat(path.c_str(), &sst) != 0 || !S_ISSOCK(sst.st_mode) ||
        sst.st_uid != getuid())
        return;
    struct sockaddr_un addr;
    if (path.size() >= sizeof(addr.sun_path)) return;
    memset(&addr, 0, sizeof(addr));
    addr.sun_family = AF_UNIX;
    memcpy(addr.sun_path, path.c_str(), path.size());
    const int fd = socket(AF_UNIX, SOCK_STREAM | SOCK_CLOEXEC, 0);
    if (fd < 0) return;
    if (connect(fd, (struct sockaddr *)&addr, sizeof(addr)) != 0) {
        close(fd);
        return;
    }
    // serve._peer_uid: a listener of another uid gets nothing either
    struct ucred cred;
    socklen_t cred_len = sizeof(cred);
    if (getsockopt(fd, SOL_SOCKET, SO_PEERCRED, &cred, &cred_len) != 0 ||
        cred.uid != getuid()) {
        close(fd);
        return;
    }
    // hello byte + our stdio fds
    int fds[3] = {0, 1, 2};
    char hello = 'F';
    struct iovec iov = {&hello, 1};
    char cbuf[CMSG_SPACE(sizeof(fds))];
    struct msghdr msg;
    memset(&msg, 0, sizeof(msg));
    msg.msg_iov = &iov;
    msg.msg_iovlen = 1;
    msg.msg_control = cbuf;
    msg.msg_controllen = sizeof(cbuf);
    struct cmsghdr *cm = CMSG_FIRSTHDR(&msg);
    cm->cmsg_level = SOL_SOCKET;
    cm->cmsg_type = SCM_RIGHTS;
    cm->cmsg_len = CMSG_LEN(sizeof(fds));
    memcpy(CMSG_DATA(cm), fds, sizeof(fds));
    if (sendmsg(fd, &msg, 0) != 1) {
        close(fd);
        return;
    }
    std::string req = "{\"argv\": [";
    for (int i = 1; i < g_argc; ++i) {
        if (i > 1) req += ", ";
        req += '"';
        json_escape(&req, g_argv[i]);
        req += '"';
    }
    req += "], \"cwd\": \"";
    char cwd[PATH_MAX];
    if (getcwd(cwd, sizeof(cwd))) json_escape(&req, cwd);
    req += "\", \"env\": {";
    bool first = true;
    for (char **e = environ; e && *e; ++e) {
        const char *eq = strchr(*e, '=');
        if (!eq) continue;
        if (!first) req += ", ";
        first = false;
        req += '"';
        std::string key(*e, (size_t)(eq - *e));
        json_escape(&req, key.c_str());
        req += "\": \"";
        json_escape(&req, eq + 1);
        req += '"';
    }
    req += "}}\n";
    size_t off = 0;
    while (off < req.size()) {
        const ssize_t n = write(fd, req.data() + off, req.size() - off);
        if (n <= 0) {
            close(fd);
            return;  // request never fully arrived: safe to fall back
        }
        off += (size_t)n;
    }
    // The request is in flight: the server may write to our tty from
    // here on, so a silent fallback would duplicate output.  Forward
    // SIGINT/SIGTERM over the socket and wait for the verdict.
    g_serve_fd = fd;
    struct sigaction sa, old_int, old_term;
    memset(&sa, 0, sizeof(sa));
    sa.sa_handler = serve_forward_sigint;
    sigaction(SIGINT, &sa, &old_int);
    sigaction(SIGTERM, &sa, &old_term);
    char line[64];
    size_t len = 0;
    bool got = false;
    while (len < sizeof(line) - 1) {
        const ssize_t n = read(fd, line + len, 1);
        if (n == 0) break;
        if (n < 0) {
            if (errno == EINTR) continue;  // signal forwarded; keep waiting
            break;
        }
        if (line[len] == '\n') {
            got = true;
            break;
        }
        ++len;
    }
    line[len] = 0;
    g_serve_fd = -1;
    sigaction(SIGINT, &old_int, nullptr);
    sigaction(SIGTERM, &old_term, nullptr);
    close(fd);
    if (got && line[0] == 'D') return;  // refused before any output
    if (got && line[0] == 'R') {
        stage("served");
        exit(atoi(line + 2));
    }
    // Protocol died mid-request: output state unknown, do not re-run.
    exit(1);
}

// utils.device_name's reading of TIMG_TPU_TORCH_DEVICE (stripped, lower
// case, "cuda" when unset or empty): true when it names the CPU.
static bool host_route() {
    const char *v = getenv("TIMG_TPU_TORCH_DEVICE");
    if (!v) return false;
    while (*v == ' ' || (*v >= '\t' && *v <= '\r')) ++v;
    size_t n = strlen(v);
    while (n > 0 && (v[n - 1] == ' ' || (v[n - 1] >= '\t' &&
                                         v[n - 1] <= '\r')))
        --n;
    return n == 3 && strncasecmp(v, "cpu", 3) == 0;
}

[[noreturn]] static void exec_fallback() {
    try_serve();
    char self[PATH_MAX];
    ssize_t n = readlink("/proc/self/exe", self, sizeof(self) - 1);
    std::string script;
    if (n > 0) {
        self[n] = 0;
        char *slash = strrchr(self, '/');
        if (slash) *slash = 0;
        script = std::string(self) + "/timg-tpu-torch";
    }
    std::vector<char *> args;
    if (!script.empty() && access(script.c_str(), X_OK) == 0) {
        args.push_back(const_cast<char *>(script.c_str()));
        for (int i = 1; i < g_argc; ++i) args.push_back(g_argv[i]);
        args.push_back(nullptr);
        execv(script.c_str(), args.data());
    }
    // Last resort: python3 -S <script> (works even without exec bit).
    args.clear();
    static const char *py = "python3";
    static const char *dashS = "-S";
    args.push_back(const_cast<char *>(py));
    if (!script.empty()) {
        args.push_back(const_cast<char *>(dashS));
        args.push_back(const_cast<char *>(script.c_str()));
        for (int i = 1; i < g_argc; ++i) args.push_back(g_argv[i]);
        args.push_back(nullptr);
        execvp(py, args.data());
    }
    fprintf(stderr,
            "timg-tpu-torch-fast: cannot locate the python launcher\n");
    exit(EXIT_PARAMETER_ERROR);
}

// ---------------------------------------------------------------------
// Env getters (utils.py mirrors; ref src/utils.cc:27-48).
// ---------------------------------------------------------------------
static bool parse_int_strict(const char *s, long *out) {
    // python int(s): optional surrounding whitespace, optional sign,
    // decimal digits only.
    while (*s == ' ' || *s == '\t' || *s == '\n' || *s == '\r' ||
           *s == '\f' || *s == '\v')
        ++s;
    const char *p = s;
    if (*p == '+' || *p == '-') ++p;
    if (*p < '0' || *p > '9') return false;
    errno = 0;
    char *end;
    long v = strtol(s, &end, 10);
    if (errno == ERANGE) return false;
    while (*end == ' ' || *end == '\t' || *end == '\n' || *end == '\r' ||
           *end == '\f' || *end == '\v')
        ++end;
    if (*end) return false;
    *out = v;
    return true;
}

static bool parse_float_strict(const char *s, double *out) {
    // python float(s): whitespace-stripped decimal/exponent (also
    // inf/nan, which strtod shares); hex floats are python-invalid.
    if (strchr(s, 'x') || strchr(s, 'X')) return false;
    const char *p = s;
    while (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r' ||
           *p == '\f' || *p == '\v')
        ++p;
    if (!*p) return false;
    if (*p == '_' ) return false;
    char *end;
    errno = 0;
    double v = strtod(p, &end);
    while (*end == ' ' || *end == '\t' || *end == '\n' || *end == '\r' ||
           *end == '\f' || *end == '\v')
        ++end;
    if (*end) return false;
    *out = v;
    return true;
}

static bool get_bool_env(const char *name, bool dflt) {
    const char *v = getenv(name);
    if (!v) return dflt;
    long iv;
    if (parse_int_strict(v, &iv) && iv > 0) return true;
    return strcasecmp(v, "on") == 0 || strcasecmp(v, "yes") == 0;
}

static double get_float_env(const char *name, double dflt) {
    const char *v = getenv(name);
    if (!v) return dflt;
    double d;
    return parse_float_strict(v, &d) ? d : dflt;
}

static long get_int_env(const char *name, long dflt) {
    const char *v = getenv(name);
    if (!v) return dflt;
    long iv;
    return parse_int_strict(v, &iv) ? iv : dflt;
}

// C atof/atoi mirrors of fast._atof/_atoi (themselves cli mirrors).
static double c_atof(const char *s) { return atof(s); }
static int c_atoi(const char *s) { return atoi(s); }

// python round(): banker's rounding == nearbyint under the default
// FE_TONEAREST mode.
static double py_round(double x) { return nearbyint(x); }

// ---------------------------------------------------------------------
// Color parsing (colors.py mirror; ref framebuffer.cc:27-50).
// ---------------------------------------------------------------------
struct RGBA {
    uint8_t r = 0, g = 0, b = 0, a = 0;
};

static bool is_space(char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
           c == '\v';
}

static int hexval(char c) {
    if (c >= '0' && c <= '9') return c - '0';
    if (c >= 'a' && c <= 'f') return c - 'a' + 10;
    if (c >= 'A' && c <= 'F') return c - 'A' + 10;
    return -1;
}

// "#rrggbb" with exactly-2-digit fields, trailing chars ignored.
static bool match_hex_color(const char *s, RGBA *out) {
    if (s[0] != '#') return false;
    int v[6];
    for (int i = 0; i < 6; ++i) {
        v[i] = hexval(s[1 + i]);
        if (v[i] < 0) return false;
    }
    out->r = (uint8_t)(v[0] * 16 + v[1]);
    out->g = (uint8_t)(v[2] * 16 + v[3]);
    out->b = (uint8_t)(v[4] * 16 + v[5]);
    out->a = 0xFF;
    return true;
}

// "rgb(\s*d+\s*,\s*d+\s*,\s*d+\s*)" anchored both ends (decimal), and
// the 0x variant.  Components clamp to 255 like python's min(v, 255).
static bool match_rgb_color(const char *s, bool hex, RGBA *out) {
    if (strncmp(s, "rgb(", 4) != 0) return false;
    const char *p = s + 4;
    unsigned long comp[3];
    for (int i = 0; i < 3; ++i) {
        while (is_space(*p)) ++p;
        if (hex) {
            if (p[0] != '0' || p[1] != 'x' || hexval(p[2]) < 0) return false;
            p += 2;
            unsigned long v = 0;
            while (hexval(*p) >= 0) {
                v = v * 16 + (unsigned long)hexval(*p);
                if (v > 0xFFFFFF) v = 0xFFFFFF;  // clamp; min() below
                ++p;
            }
            comp[i] = v;
        } else {
            if (*p < '0' || *p > '9') return false;
            unsigned long v = 0;
            while (*p >= '0' && *p <= '9') {
                v = v * 10 + (unsigned long)(*p - '0');
                if (v > 0xFFFFFF) v = 0xFFFFFF;
                ++p;
            }
            comp[i] = v;
        }
        while (is_space(*p)) ++p;
        if (i < 2) {
            if (*p != ',') return false;
            ++p;
        }
    }
    if (*p != ')' || p[1] != 0) return false;
    out->r = (uint8_t)(comp[0] > 255 ? 255 : comp[0]);
    out->g = (uint8_t)(comp[1] > 255 ? 255 : comp[1]);
    out->b = (uint8_t)(comp[2] > 255 ? 255 : comp[2]);
    out->a = 0xFF;
    return true;
}

static std::string lowered(const char *s) {
    std::string r(s);
    for (char &c : r)
        if (c >= 'A' && c <= 'Z') c += 32;
    return r;
}

static const Css3Color *css3_lookup(const std::string &lower) {
    for (const auto &e : kCss3Colors)
        if (lower == e.name) return &e;
    return nullptr;
}

// colors.parse_color mirror.  Callers pre-check would_warn, so the
// warning branch is unreachable here but kept for exactness.
static RGBA parse_color(const char *color) {
    RGBA out;  // transparent
    if (!color || !*color) return out;
    std::string low = lowered(color);
    const Css3Color *named = css3_lookup(low);
    char buf[16];
    if (named) {
        snprintf(buf, sizeof(buf), "#%02x%02x%02x", named->r, named->g,
                 named->b);
        color = buf;
    }
    if (match_hex_color(color, &out)) return out;
    if (match_rgb_color(color, false, &out)) return out;
    if (match_rgb_color(color, true, &out)) return out;
    if (low != "none")
        fprintf(stderr, "Couldn't parse color '%s'\n", color);
    RGBA t;
    return t;
}

// fast._color_would_warn mirror: true when parse_color would print.
static bool color_would_warn(const char *color) {
    if (!color || !*color) return false;
    std::string low = lowered(color);
    if (low == "none" || css3_lookup(low)) return false;
    RGBA tmp;
    return !(match_hex_color(color, &tmp) || match_rgb_color(color, false, &tmp)
             || match_rgb_color(color, true, &tmp));
}

// ---------------------------------------------------------------------
// Terminal queries (term.py mirrors; ref src/term-query.cc).
// ---------------------------------------------------------------------
static int find_tty_fd() {
    // stdout, stderr, stdin -- first real tty (ref term-query.cc:84-91).
    const int fds[3] = {1, 2, 0};
    for (int fd : fds)
        if (isatty(fd)) return fd;
    return -1;
}

typedef bool (*ResponseFound)(const std::string &);

static std::string query_terminal(const char *query, size_t query_len,
                                  double timeout_s, ResponseFound found) {
    int fd = find_tty_fd();
    if (fd < 0) return "";
    struct termios old_t;
    if (tcgetattr(fd, &old_t) != 0) return "";
    std::string buf;
    struct termios raw = old_t;
    // The reference's raw mode (term-query.cc:99-106): iflag cleared,
    // ICANON|ECHO off, VMIN/VTIME 0 -- OPOST and ISIG stay ON.
    raw.c_iflag = 0;
    raw.c_lflag &= ~(ICANON | ECHO);
    raw.c_cc[VMIN] = 0;
    raw.c_cc[VTIME] = 0;
    tcsetattr(fd, TCSANOW, &raw);
    ssize_t wr = write(fd, query, query_len);
    (void)wr;
    struct timespec t0;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    double deadline = t0.tv_sec + t0.tv_nsec * 1e-9 + timeout_s;
    for (;;) {
        struct timespec now;
        clock_gettime(CLOCK_MONOTONIC, &now);
        double remaining = deadline - (now.tv_sec + now.tv_nsec * 1e-9);
        if (remaining <= 0) break;
        fd_set rfds;
        FD_ZERO(&rfds);
        FD_SET(fd, &rfds);
        struct timeval tv;
        tv.tv_sec = (time_t)remaining;
        tv.tv_usec = (suseconds_t)((remaining - (double)tv.tv_sec) * 1e6);
        int r = select(fd + 1, &rfds, nullptr, nullptr, &tv);
        if (r <= 0) break;
        char chunk[512];
        ssize_t n = read(fd, chunk, sizeof(chunk));
        if (n <= 0) break;
        buf.append(chunk, (size_t)n);
        if (found && found(buf)) break;
    }
    // TCSAFLUSH like the reference's clean_up_terminal (:40-45).
    tcsetattr(fd, TCSAFLUSH, &old_t);
    return buf;
}

struct TermSize {
    int cols = -1, rows = -1;
    // -2/-1 keeps the 1:2 cell ratio trick (ref term-query.h:29-30).
    int font_width_px = -1, font_height_px = -2;
};

static bool cellsize_found(const std::string &b) {
    // \033[6;<digits>;<digits>t
    size_t p = 0;
    while ((p = b.find("\033[6;", p)) != std::string::npos) {
        size_t q = p + 4;
        size_t d1 = q;
        while (q < b.size() && b[q] >= '0' && b[q] <= '9') ++q;
        if (q > d1 && q < b.size() && b[q] == ';') {
            size_t d2 = ++q;
            while (q < b.size() && b[q] >= '0' && b[q] <= '9') ++q;
            if (q > d2 && q < b.size() && b[q] == 't') return true;
        }
        ++p;
    }
    return false;
}

static TermSize determine_term_size() {
    TermSize result;
    int fd = find_tty_fd();
    if (fd < 0) return result;
    struct winsize w;
    if (ioctl(fd, TIOCGWINSZ, &w) != 0) return result;
    result.cols = w.ws_col;
    result.rows = w.ws_row;
    if (w.ws_row > 0 && w.ws_col > 0 && w.ws_xpixel >= 2 * w.ws_col &&
        w.ws_ypixel >= 4 * w.ws_row) {
        // Plausible pixel values: font at least 2x4 px (ref :386-392).
        result.font_width_px = w.ws_xpixel / w.ws_col;
        result.font_height_px = w.ws_ypixel / w.ws_row;
    } else {
        // Fallback: cell size query CSI 16t, 50ms budget (ref :347-366).
        std::string resp =
            query_terminal("\033[16t", 5, 0.05, cellsize_found);
        size_t p = 0;
        while ((p = resp.find("\033[6;", p)) != std::string::npos) {
            int hpx = 0, wpx = 0;
            if (sscanf(resp.c_str() + p, "\033[6;%d;%dt", &hpx, &wpx) == 2) {
                result.font_height_px = hpx;
                result.font_width_px = wpx;
                break;
            }
            ++p;
        }
    }
    return result;
}

static bool bg_found(const std::string &b) {
    size_t i = b.find("rgb:");
    return i != std::string::npos && b.find('\\', i) != std::string::npos;
}

// term.query_background_color mirror: returns false when no parsable
// reply arrived (python returns None -> parse_color(None) ==
// transparent).
static bool query_background_color(RGBA *out) {
    std::string resp =
        query_terminal("\033]11;?\033\\", 7, 1.5, bg_found);
    size_t p = resp.find("\033]11;rgb:");
    if (p == std::string::npos) return false;
    const char *s = resp.c_str() + p + 9;
    // ([hex]+)/([hex]+)/([hex]+): take the first two digits of each
    // component verbatim (high byte; ref term-query.cc:210-220).
    uint8_t comp[3];
    for (int i = 0; i < 3; ++i) {
        if (hexval(*s) < 0) return false;
        int hi = hexval(*s);
        ++s;
        int lo = 0;  // "0"-padded when the component is a single digit
        if (hexval(*s) >= 0) lo = hexval(*s);
        while (hexval(*s) >= 0) ++s;
        comp[i] = (uint8_t)(hi * 16 + lo);
        if (i < 2) {
            if (*s != '/') return false;
            ++s;
        }
    }
    out->r = comp[0];
    out->g = comp[1];
    out->b = comp[2];
    out->a = 0xFF;
    return true;
}

enum Graphics { G_NONE, G_KITTY, G_ITERM2, G_SIXEL };

struct GraphicsInfo {
    Graphics preferred = G_NONE;
    bool in_tmux = false;
    bool sixel_broken_cursor = false;
    bool sixel_full_cell_jump = false;
};

static bool gfx_found(const std::string &b) {
    return b.find("\033[0") != std::string::npos;
}

static bool da1_found(const std::string &b) {
    return b.find("\033[?") != std::string::npos;
}

// \033\[\?[0-9;]*?;4[;c] (term.py DA1 sixel matcher).
static bool da1_has_sixel(const std::string &b) {
    size_t p = 0;
    while ((p = b.find("\033[?", p)) != std::string::npos) {
        size_t j = p + 3;
        while (j < b.size() &&
               ((b[j] >= '0' && b[j] <= '9') || b[j] == ';')) {
            if (b[j] == ';' && j + 2 < b.size() && b[j + 1] == '4' &&
                (b[j + 2] == ';' || b[j + 2] == 'c'))
                return true;
            ++j;
        }
        ++p;
    }
    return false;
}

// term.query_supported_graphics_protocol mirror (ref :226-345).
static GraphicsInfo query_graphics() {
    GraphicsInfo info;
    const char *term = getenv("TERM");
    const char *term_program = getenv("TERM_PROGRAM");
    if (!term) term = "";
    if (!term_program) term_program = "";
    long quirk = get_int_env("TIMG_SIXEL_NEWLINE_WORKAROUND", 0);
    info.sixel_broken_cursor = (quirk & 1) != 0;
    info.sixel_full_cell_jump = (quirk & 2) != 0;
    const char *tmux_env = getenv("TMUX");
    info.in_tmux = (tmux_env && *tmux_env) ||
                   strncmp(term, "tmux", 4) == 0;

    if (strcmp(term, "xterm-kitty") == 0 || strcmp(term, "xterm-ghostty") == 0)
        info.preferred = G_KITTY;
    if (strcmp(term_program, "vscode") == 0) {
        info.preferred = G_ITERM2;
        info.sixel_broken_cursor = true;
    } else if (strcmp(term_program, "WarpTerminal") == 0) {
        info.preferred = G_ITERM2;
    }

    std::string txt = query_terminal("\033[>q\033[5n", 8, 0.25, gfx_found);
    // Sequential case-sensitive matchers in the reference's order.
    if (txt.find("iTerm2") != std::string::npos ||
        txt.find("Konsole 2") != std::string::npos)
        info.preferred = G_ITERM2;
    if (txt.find("WezTerm") != std::string::npos) {
        info.preferred = G_ITERM2;
        info.sixel_broken_cursor = true;
    }
    if (txt.find("kitty") != std::string::npos) info.preferred = G_KITTY;
    if (txt.find("ghostty") != std::string::npos) info.preferred = G_KITTY;
    if (txt.find("mlterm") != std::string::npos) info.preferred = G_SIXEL;
    if (txt.find("XTerm") != std::string::npos)
        info.sixel_broken_cursor = true;
    if (txt.find("foot") != std::string::npos) {
        info.preferred = G_SIXEL;
        info.sixel_broken_cursor = true;
    }
    if (txt.find("tmux") != std::string::npos) info.in_tmux = true;
    if (txt.find("WindowsTerminal") != std::string::npos) {
        info.sixel_broken_cursor = true;
        info.sixel_full_cell_jump = true;
    }
    if (info.preferred == G_NONE) {
        std::string da1 = query_terminal("\033[c", 3, 0.25, da1_found);
        if (da1_has_sixel(da1)) info.preferred = G_SIXEL;
    }
    return info;
}

// ---------------------------------------------------------------------
// base64 + PNG assembly (render/png_core.py mirrors; ref timg-png.cc).
// ---------------------------------------------------------------------
static const char kB64[] =
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";

static void b64_append(std::string *out, const uint8_t *data, size_t len) {
    size_t i = 0;
    for (; i + 3 <= len; i += 3) {
        uint32_t v = ((uint32_t)data[i] << 16) | ((uint32_t)data[i + 1] << 8) |
                     data[i + 2];
        out->push_back(kB64[(v >> 18) & 63]);
        out->push_back(kB64[(v >> 12) & 63]);
        out->push_back(kB64[(v >> 6) & 63]);
        out->push_back(kB64[v & 63]);
    }
    if (i + 1 == len) {
        uint32_t v = (uint32_t)data[i] << 16;
        out->push_back(kB64[(v >> 18) & 63]);
        out->push_back(kB64[(v >> 12) & 63]);
        out->push_back('=');
        out->push_back('=');
    } else if (i + 2 == len) {
        uint32_t v = ((uint32_t)data[i] << 16) | ((uint32_t)data[i + 1] << 8);
        out->push_back(kB64[(v >> 18) & 63]);
        out->push_back(kB64[(v >> 12) & 63]);
        out->push_back(kB64[(v >> 6) & 63]);
        out->push_back('=');
    }
}

static void be32_append(std::string *out, uint32_t v) {
    out->push_back((char)(v >> 24));
    out->push_back((char)(v >> 16));
    out->push_back((char)(v >> 8));
    out->push_back((char)v);
}

static void png_chunk_append(std::string *out, const char type[4],
                             const uint8_t *payload, size_t len) {
    be32_append(out, (uint32_t)len);
    size_t crc_start = out->size();
    out->append(type, 4);
    out->append((const char *)payload, len);
    uint32_t crc = timg_crc32(
        0, (const uint8_t *)out->data() + crc_start, (long)(4 + len));
    be32_append(out, crc);
}

// encode_png_from_filtered mirror: IHDR + one IDAT + IEND, Sub-filtered
// scanlines compressed by the library png_core.zlib_compress takes
// (libdeflate, else zlib's compress2), at the same level -- identical
// bytes by identical library.  Where neither loads, the run cannot
// write the PNG the python path writes: bail before any output.
static std::string encode_png_from_filtered(const uint8_t *raw, size_t rawlen,
                                            int w, int h, int level,
                                            bool with_alpha) {
    uint8_t *z = nullptr;
    const long n = timg_zlib_compress(raw, (long)rawlen, level, &z);
    if (n < 0) exec_fallback();
    std::string idat((const char *)z, (size_t)n);
    timg_buf_free(z);
    std::string out("\x89PNG\r\n\x1a\n", 8);
    uint8_t ihdr[13];
    ihdr[0] = (uint8_t)(w >> 24); ihdr[1] = (uint8_t)(w >> 16);
    ihdr[2] = (uint8_t)(w >> 8);  ihdr[3] = (uint8_t)w;
    ihdr[4] = (uint8_t)(h >> 24); ihdr[5] = (uint8_t)(h >> 16);
    ihdr[6] = (uint8_t)(h >> 8);  ihdr[7] = (uint8_t)h;
    ihdr[8] = 8;
    ihdr[9] = with_alpha ? 6 : 2;
    ihdr[10] = ihdr[11] = ihdr[12] = 0;
    png_chunk_append(&out, "IHDR", ihdr, 13);
    png_chunk_append(&out, "IDAT", (const uint8_t *)idat.data(), idat.size());
    png_chunk_append(&out, "IEND", nullptr, 0);
    return out;
}

// fast._reliable_write mirror (stop on broken pipe / w<=0).
static void reliable_write(int fd, const char *buf, size_t len) {
    while (len > 0) {
        ssize_t n = write(fd, buf, len);
        if (n <= 0) {
            if (n < 0 && errno == EINTR) continue;
            return;
        }
        buf += n;
        len -= (size_t)n;
    }
}

// ---------------------------------------------------------------------
// Argument parsing.  fast.py parses with argparse (args.py table, a
// getopt mirror of ref timg.cc:495-524).  Any token this parser is not
// POSITIVE about falls back to the python launcher, which reproduces
// argparse's exact messages and codes.
// ---------------------------------------------------------------------
static const char *const BARE = "\x01";  // marker for a bare optional flag

struct Args {
    const char *pixelation = nullptr;          // -p
    bool center = false;                       // -C
    std::vector<const char *> title;           // --title (BARE or value)
    std::vector<const char *> filelist;        // -f
    std::vector<const char *> filelist_rel;    // -F
    const char *bg_color = "auto";             // -b
    const char *bg_pattern_color = nullptr;    // -B
    long pattern_size = 1;                     // --pattern-size
    const char *rotate = "exif";               // --rotate
    bool fit_width = false;                    // -W
    int upscale_short = 0;                     // -U count
    std::vector<const char *> upscale;         // --upscale
    std::vector<const char *> clear_vals;      // --clear
    bool no_antialias = false;                 // -a
    const char *wait = nullptr;                // -w
    const char *geometry = nullptr;            // -g
    const char *outfile = nullptr;             // -o
    bool no_hide_cursor = false;               // -E
    std::vector<const char *> compress;        // --compress
    bool color8 = false;                       // --color8
    bool has_duration = false;                 // -t
    double duration = 0.0;
    bool debug_no_frame_delay = false;
    const char *dither = "libsixel";           // --dither
    const char *grid = nullptr;                // --grid
    std::vector<const char *> scroll_vals;     // --scroll
    const char *delta_move = nullptr;          // -d / --delta-move
    std::vector<const char *> loops_vals;      // --loops / -c
    std::vector<const char *> files;
};

// argparse consumes a separate token as an option's value only when it
// does not itself look like an option: anything not starting with '-',
// a bare "-", or a negative number (argparse._negative_number_matcher,
// active because no option string of ours is numeric).
static bool looks_like_value(const char *tok) {
    if (tok[0] != '-') return true;
    if (tok[1] == 0) return true;  // "-"
    const char *p = tok + 1;
    bool digits = false;
    while (*p >= '0' && *p <= '9') {
        ++p;
        digits = true;
    }
    if (*p == 0) return digits;          // -\d+
    if (*p != '.') return false;
    ++p;
    bool frac = false;
    while (*p >= '0' && *p <= '9') {
        ++p;
        frac = true;
    }
    return frac && *p == 0;              // -\d*\.\d+
}

// Parse argv into Args.  Returns false -> exec_fallback (unknown flag,
// parse error, or a flag whose presence routes to the full path).
static bool parse_args(int argc, char **argv, Args *a) {
    bool positional_only = false;
    for (int i = 1; i < argc; ++i) {
        const char *tok = argv[i];
        if (positional_only || tok[0] != '-' || tok[1] == 0) {
            a->files.push_back(tok);
            continue;
        }
        if (strcmp(tok, "--") == 0) {
            positional_only = true;
            continue;
        }
        if (tok[1] == '-') {
            // Long option.  Exact names only: argparse accepts
            // unambiguous abbreviations, which fall back to python.
            const char *eq = strchr(tok, '=');
            std::string name(tok, eq ? (size_t)(eq - tok) : strlen(tok));
            const char *attached = eq ? eq + 1 : nullptr;
            // Flags whose mere presence is outside the envelope:
            if (name == "--auto-crop" ||
                name == "--version" || name == "--verbose" ||
                name == "--help" || name == "--frames" ||
                name == "--devices")
                return false;
            if (name == "--frame-offset") {
                // --frame-offset=0 stays in the envelope (fast.py bails
                // only on a nonzero offset).
                const char *v = attached;
                if (!v) {
                    if (i + 1 >= argc || !looks_like_value(argv[i + 1]))
                        return false;
                    v = argv[++i];
                }
                long off;
                if (!parse_int_strict(v, &off) || off != 0) return false;
                continue;
            }
            auto required = [&](const char **slot) -> bool {
                if (attached) {
                    *slot = attached;
                    return true;
                }
                // A following option-looking token is an argparse
                // "expected one argument" error -> python reproduces it.
                if (i + 1 >= argc || !looks_like_value(argv[i + 1]))
                    return false;
                *slot = argv[++i];
                return true;
            };
            if (name == "--pixelation") {
                if (!required(&a->pixelation)) return false;
            } else if (name == "--grid") {
                if (!required(&a->grid)) return false;
            } else if (name == "--scroll") {
                a->scroll_vals.push_back(attached ? attached : BARE);
            } else if (name == "--delta-move") {
                if (!required(&a->delta_move)) return false;
            } else if (name == "--center") {
                if (attached) return false;  // argparse: explicit-arg error
                a->center = true;
            } else if (name == "--title") {
                a->title.push_back(attached ? attached : BARE);
            } else if (name == "--pattern-size") {
                const char *v;
                if (!required(&v)) return false;
                if (!parse_int_strict(v, &a->pattern_size)) return false;
            } else if (name == "--rotate") {
                if (!required(&a->rotate)) return false;
            } else if (name == "--fit-width") {
                if (attached) return false;
                a->fit_width = true;
            } else if (name == "--upscale") {
                a->upscale.push_back(attached ? attached : BARE);
            } else if (name == "--clear") {
                a->clear_vals.push_back(attached ? attached : BARE);
            } else if (name == "--compress") {
                a->compress.push_back(attached ? attached : BARE);
            } else if (name == "--threads") {
                const char *v;
                long unused;
                if (!required(&v)) return false;
                if (!parse_int_strict(v, &unused)) return false;
                // decode-pool sizing: inert for the one-shot still path
            } else if (name == "--color8") {
                if (attached) return false;
                a->color8 = true;
            } else if (name == "--loops") {
                a->loops_vals.push_back(attached ? attached : BARE);
            } else if (name == "--debug-no-frame-delay") {
                if (attached) return false;
                a->debug_no_frame_delay = true;
            } else if (name == "--dither") {
                const char *v;
                if (!required(&v)) return false;
                if (strcmp(v, "adaptive") && strcmp(v, "cube") &&
                    strcmp(v, "libsixel"))
                    return false;  // argparse choice error -> python
                a->dither = v;
            } else if (name == "--resample") {
                // video-only flag: 'auto' is a no-op for stills (stay
                // native); 'sws' and bad values go to the python CLI
                const char *v;
                if (!required(&v)) return false;
                if (strcmp(v, "auto")) return false;
            } else {
                return false;  // unknown / abbreviated long flag
            }
            continue;
        }
        // Short option cluster.  argparse semantics: a value short
        // takes the rest of the token, else the next token.
        for (const char *p = tok + 1; *p; ++p) {
            char c = *p;
            const char *rest = p + 1;
            auto value = [&](const char **slot) -> bool {
                if (*rest) {
                    *slot = rest;
                    return true;
                }
                if (i + 1 >= argc || !looks_like_value(argv[i + 1]))
                    return false;
                *slot = argv[++i];
                return true;
            };
            bool consumed_rest = false;
            switch (c) {
                case 'p':
                    if (!value(&a->pixelation)) return false;
                    consumed_rest = true;
                    break;
                case 'f': {
                    const char *v;
                    if (!value(&v)) return false;
                    a->filelist.push_back(v);
                    consumed_rest = true;
                    break;
                }
                case 'F': {
                    const char *v;
                    if (!value(&v)) return false;
                    a->filelist_rel.push_back(v);
                    consumed_rest = true;
                    break;
                }
                case 'b':
                    if (!value(&a->bg_color)) return false;
                    consumed_rest = true;
                    break;
                case 'B':
                    if (!value(&a->bg_pattern_color)) return false;
                    consumed_rest = true;
                    break;
                case 'w':
                    if (!value(&a->wait)) return false;
                    consumed_rest = true;
                    break;
                case 'g':
                    if (!value(&a->geometry)) return false;
                    consumed_rest = true;
                    break;
                case 'o':
                    if (!value(&a->outfile)) return false;
                    consumed_rest = true;
                    break;
                case 't': {
                    const char *v;
                    if (!value(&v)) return false;
                    if (!parse_float_strict(v, &a->duration)) return false;
                    a->has_duration = true;
                    consumed_rest = true;
                    break;
                }
                case 'c': {
                    // --loops short form: argparse nargs='?' consumes
                    // an attached rest or a value-looking next token.
                    if (*rest) {
                        a->loops_vals.push_back(rest);
                        consumed_rest = true;
                    } else if (i + 1 < argc && looks_like_value(argv[i + 1])) {
                        a->loops_vals.push_back(argv[++i]);
                    } else {
                        a->loops_vals.push_back(BARE);
                    }
                    break;
                }
                case 'd':
                    if (!value(&a->delta_move)) return false;
                    consumed_rest = true;
                    break;
                case 'C': a->center = true; break;
                case 'W': a->fit_width = true; break;
                case 'U': a->upscale_short++; break;
                case 'I': break;  // image-only: stills are images
                case 'a': a->no_antialias = true; break;
                case 'E': a->no_hide_cursor = true; break;
                case 'v': break;  // in the optstring, no handler (ref)
                case 'V':         // video-only
                case 'h':         // help
                default:
                    return false;
            }
            if (consumed_rest) break;
        }
    }
    return true;
}

// ---------------------------------------------------------------------
// Rendering: decode one PNG still -> planes (fast._NativeStill mirror).
// ---------------------------------------------------------------------
struct Display {
    int width = 0, height = 0;
    int cell_x = 1, cell_y = 2;
    double width_stretch = 1.0;
    bool upscale = false, upscale_integer = false;
    bool fill_width = false;
    bool fill_height = false;
    bool scroll_on = false;
    int scroll_dx = 1, scroll_dy = 0;
    double scroll_delay_ms = 50.0;
    bool antialias = true;
    bool exif_rotate = true;
    long pattern_size = 1;
    RGBA bg_pattern_color;
    bool quarter = false;
    bool use_upper = false;
    enum Mode { HALF, QUARTER, SIXEL, KITTY, ITERM2 } mode = QUARTER;
};

struct AnimFrame {
    // block planes (quarter/half)
    std::vector<int32_t> glyph;
    std::vector<uint8_t> fg, bg, padded;
    int hcells = 0, wcells = 0;
    int padded_h = 0;
    // kitty/iterm2: composed RGBA at target size
    std::vector<uint8_t> frame;
    // sixel: pre-assembled DCS stream (bucket-table pipeline)
    std::string sixel_stream;
    double delay_ms = 0.0;
};

struct Planes {
    bool missing = false;       // error message instead of pixels
    std::string error;
    // animation (>= 2 entries); empty for stills
    std::vector<AnimFrame> anim;
    bool scroll = false;          // scroll semantics (pre-check budget,
                                  // raw end-of-frame times)
    double scroll_delay_ms = 50.0;
    // blocks
    bool is_blocks = false;
    std::vector<int32_t> glyph;
    std::vector<uint8_t> fg, bg;
    int hcells = 0, wcells = 0;
    // pixel-direct
    std::vector<uint8_t> frame;  // composed RGBA
    std::string sixel_stream;    // pre-built DCS payload (sixel mode)
    int target_w = 0, target_h = 0;
    int orig_w = 0, orig_h = 0;
};

struct BgCache {
    bool have = false;
    RGBA value;
};

static RGBA bg_get(BgCache *cache, const char *bg_color) {
    if (!cache->have) {
        if (strcasecmp(bg_color, "auto") == 0) {
            RGBA v;
            if (!query_background_color(&v)) v = RGBA();  // transparent
            cache->value = v;
        } else {
            cache->value = parse_color(bg_color);
        }
        cache->have = true;
    }
    return cache->value;
}

// ---------------------------------------------------------------------
// JPEG stills (fast._render_pil JPEG-path mirror).
//
// PIL decodes JPEG through the libjpeg-turbo it BUNDLES
// (site-packages/pillow.libs/libjpeg-*.so); dlopening that exact
// library with Pillow's decoder settings (default ISLOW DCT + fancy
// upsampling, scale_denom from draft()) reproduces PIL's bytes, so the
// python fastpath and this launcher stay byte-identical.  Falls back
// to the system libjpeg.so.62 (same frozen v62 ABI), and bails to the
// python launcher whenever anything is off-script: CMYK, MPO (APP2
// MPF), EXIF orientation != 1, decoder warnings, parse anomalies.
// ---------------------------------------------------------------------
#include <dlfcn.h>
#include <glob.h>
#if __has_include(<jpeglib.h>)
#include <jpeglib.h>
#include <setjmp.h>

struct JpegApi {
    struct jpeg_error_mgr *(*std_error)(struct jpeg_error_mgr *);
    void (*create_decompress)(j_decompress_ptr, int, size_t);
    void (*mem_src)(j_decompress_ptr, const unsigned char *,
                    unsigned long);
    int (*read_header)(j_decompress_ptr, boolean);
    boolean (*start_decompress)(j_decompress_ptr);
    JDIMENSION (*read_scanlines)(j_decompress_ptr, JSAMPARRAY, JDIMENSION);
    boolean (*finish_decompress)(j_decompress_ptr);
    void (*destroy_decompress)(j_decompress_ptr);
};

static JpegApi *jpeg_api() {
    static JpegApi api;
    static int state = 0;  // 0 untried, 1 ok, -1 failed
    if (state) return state > 0 ? &api : nullptr;
    state = -1;
    void *h = nullptr;
    const char *override = getenv("TIMG_TPU_PILLOW_JPEG");
    if (override && *override) h = dlopen(override, RTLD_NOW | RTLD_LOCAL);
    if (!h) {
        // Pillow's bundled libjpeg-turbo (name is hash-mangled).
        static const char *pats[] = {
            "/opt/venv/lib/python3*/site-packages/pillow.libs/"
            "libjpeg-*.so*",
            "/usr/lib/python3*/site-packages/pillow.libs/libjpeg-*.so*",
            "/usr/local/lib/python3*/site-packages/pillow.libs/"
            "libjpeg-*.so*",
        };
        for (const char *pat : pats) {
            glob_t g;
            if (glob(pat, 0, nullptr, &g) == 0 && g.gl_pathc > 0)
                h = dlopen(g.gl_pathv[0], RTLD_NOW | RTLD_LOCAL);
            globfree(&g);
            if (h) break;
        }
    }
    if (!h) h = dlopen("libjpeg.so.62", RTLD_NOW | RTLD_LOCAL);
    if (!h) return nullptr;
    api.std_error = (struct jpeg_error_mgr * (*)(struct jpeg_error_mgr *))
        dlsym(h, "jpeg_std_error");
    api.create_decompress = (void (*)(j_decompress_ptr, int, size_t))dlsym(
        h, "jpeg_CreateDecompress");
    api.mem_src = (void (*)(j_decompress_ptr, const unsigned char *,
                            unsigned long))dlsym(h, "jpeg_mem_src");
    api.read_header =
        (int (*)(j_decompress_ptr, boolean))dlsym(h, "jpeg_read_header");
    api.start_decompress =
        (boolean (*)(j_decompress_ptr))dlsym(h, "jpeg_start_decompress");
    api.read_scanlines = (JDIMENSION (*)(j_decompress_ptr, JSAMPARRAY,
                                         JDIMENSION))
        dlsym(h, "jpeg_read_scanlines");
    api.finish_decompress =
        (boolean (*)(j_decompress_ptr))dlsym(h, "jpeg_finish_decompress");
    api.destroy_decompress =
        (void (*)(j_decompress_ptr))dlsym(h, "jpeg_destroy_decompress");
    if (!api.std_error || !api.create_decompress || !api.mem_src ||
        !api.read_header || !api.start_decompress || !api.read_scanlines ||
        !api.finish_decompress || !api.destroy_decompress)
        return nullptr;
    state = 1;
    return &api;
}

struct JpegErr {
    struct jpeg_error_mgr mgr;
    jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr *e = (JpegErr *)cinfo->err;
    longjmp(e->jb, 1);
}
static void jpeg_err_silent(j_common_ptr, int) {}
static void jpeg_err_output(j_common_ptr) {}

// Scan the pre-SOS marker segments: EXIF orientation (APP1 "Exif\0\0",
// IFD0 tag 0x0112) and MPO detection (APP2 "MPF\0").  Mirrors what
// PIL's _open/applist collection exposes to fast.py.  Returns false on
// any anomaly the python path should arbitrate (bail).
static bool jpeg_scan_markers(const uint8_t *d, size_t len,
                              bool want_exif, int *orientation,
                              bool *is_mpo) {
    *orientation = 1;
    *is_mpo = false;
    bool exif_seen = false;
    size_t p = 2;  // past SOI
    while (p + 4 <= len) {
        if (d[p] != 0xFF) return false;
        uint8_t m = d[p + 1];
        if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01 ||
            m == 0xFF) {
            p += 2;
            continue;
        }
        if (m == 0xDA || m == 0xD9) break;  // SOS / EOI: done
        size_t seglen = ((size_t)d[p + 2] << 8) | d[p + 3];
        if (seglen < 2 || p + 2 + seglen > len) return false;
        const uint8_t *seg = d + p + 4;
        size_t sl = seglen - 2;
        if (m == 0xE2 && sl >= 4 && memcmp(seg, "MPF\0", 4) == 0)
            *is_mpo = true;
        if (m == 0xE1 && !exif_seen && sl >= 6 &&
            memcmp(seg, "Exif\0\0", 6) == 0) {
            exif_seen = true;
            if (want_exif) {
                // TIFF header at seg+6.
                const uint8_t *t = seg + 6;
                size_t tl = sl - 6;
                if (tl < 8) return false;
                bool le;
                if (t[0] == 'I' && t[1] == 'I')
                    le = true;
                else if (t[0] == 'M' && t[1] == 'M')
                    le = false;
                else
                    return false;
                auto r16 = [&](size_t off) -> unsigned {
                    return le ? t[off] | (t[off + 1] << 8)
                              : (t[off] << 8) | t[off + 1];
                };
                auto r32 = [&](size_t off) -> unsigned long {
                    return le ? (unsigned long)t[off] |
                                    ((unsigned long)t[off + 1] << 8) |
                                    ((unsigned long)t[off + 2] << 16) |
                                    ((unsigned long)t[off + 3] << 24)
                              : ((unsigned long)t[off] << 24) |
                                    ((unsigned long)t[off + 1] << 16) |
                                    ((unsigned long)t[off + 2] << 8) |
                                    (unsigned long)t[off + 3];
                };
                if (r16(2) != 42) return false;
                unsigned long ifd = r32(4);
                if (ifd + 2 > tl) return false;
                unsigned nent = r16(ifd);
                if (ifd + 2 + (unsigned long)nent * 12 > tl) return false;
                for (unsigned i = 0; i < nent; ++i) {
                    size_t e = ifd + 2 + (size_t)i * 12;
                    if (r16(e) != 0x0112) continue;
                    unsigned type = r16(e + 2);
                    unsigned long count = r32(e + 4);
                    if (count != 1) return false;
                    if (type == 3)
                        *orientation = (int)r16(e + 8);
                    else if (type == 4)
                        *orientation = (int)r32(e + 8);
                    else
                        return false;
                    break;
                }
            }
        }
        p += 2 + seglen;
    }
    return true;
}

// Decode a JPEG still with PIL-identical settings.  Returns malloc'd
// RGBA on success; *true_w/h = pre-draft dims, *out_w/h = decoded
// (possibly drafted) dims.  nullptr -> bail to the python launcher.
static uint8_t *decode_jpeg_still(const uint8_t *data, size_t len,
                                  const Display &disp, int *out_w,
                                  int *out_h, int *true_w, int *true_h) {
    JpegApi *J = jpeg_api();
    if (!J) return nullptr;
    int orientation = 1;
    bool is_mpo = false;
    if (!jpeg_scan_markers(data, len, disp.exif_rotate, &orientation,
                           &is_mpo))
        return nullptr;
    if (is_mpo) return nullptr;            // PIL shows MPO as multi-frame
    if (orientation != 1) return nullptr;  // PIL would exif_transpose

    struct jpeg_decompress_struct cinfo;
    JpegErr jerr;
    memset(&cinfo, 0, sizeof(cinfo));
    cinfo.err = J->std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    jerr.mgr.emit_message = jpeg_err_silent;
    jerr.mgr.output_message = jpeg_err_output;
    uint8_t *rgba = nullptr;
    uint8_t *rowbuf = nullptr;
    if (setjmp(jerr.jb)) {
        J->destroy_decompress(&cinfo);
        free(rgba);
        free(rowbuf);
        return nullptr;
    }
    J->create_decompress(&cinfo, JPEG_LIB_VERSION,
                         sizeof(struct jpeg_decompress_struct));
    J->mem_src(&cinfo, data, (unsigned long)len);
    if (J->read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        J->destroy_decompress(&cinfo);
        return nullptr;
    }
    const int ncomp = cinfo.num_components;
    if (ncomp != 3 && ncomp != 1) {  // CMYK etc: python path decides
        J->destroy_decompress(&cinfo);
        return nullptr;
    }
    *true_w = (int)cinfo.image_width;
    *true_h = (int)cinfo.image_height;
    if (*true_w <= 0 || *true_h <= 0 ||
        (long)*true_w * *true_h > (1L << 30)) {
        J->destroy_decompress(&cinfo);
        return nullptr;
    }
    // DCT-domain draft (fast.py mirror of PIL draft(), itself the
    // analog of ref jpeg-source.cc:184-195): same guards, same
    // 8/4/2/1 snap, ceil-div output dims via libjpeg scale_denom.
    int tw = 0, th = 0;
    timg_calc_scale(*true_w, *true_h, disp.width, disp.height,
                    disp.fill_width ? 1 : 0, disp.fill_height ? 1 : 0,
                    disp.width_stretch,
                    disp.upscale ? 1 : 0, disp.upscale_integer ? 1 : 0,
                    disp.cell_x, disp.cell_y, 0, &tw, &th);
    if (tw > 0 && th > 0 && *true_w >= 2 * tw && *true_h >= 2 * th) {
        int scale = *true_w / tw;
        const int sh = *true_h / th;
        if (sh < scale) scale = sh;
        int s = 1;
        for (int cand : {8, 4, 2, 1}) {
            if (scale >= cand) {
                s = cand;
                break;
            }
        }
        if (s > 1) {
            cinfo.scale_num = 1;
            cinfo.scale_denom = (unsigned)s;
        }
    }
    // Pillow decoder defaults: ISLOW DCT, fancy upsampling, explicit
    // out_color_space from the mode.
    cinfo.out_color_space = (ncomp == 3) ? JCS_RGB : JCS_GRAYSCALE;
    J->start_decompress(&cinfo);
    const int w = (int)cinfo.output_width;
    const int h = (int)cinfo.output_height;
    const int oc = cinfo.output_components;
    if (w <= 0 || h <= 0 || (oc != 3 && oc != 1)) {
        J->destroy_decompress(&cinfo);
        return nullptr;
    }
    rgba = (uint8_t *)malloc((size_t)w * h * 4);
    rowbuf = (uint8_t *)malloc((size_t)w * oc);
    if (!rgba || !rowbuf) {
        J->destroy_decompress(&cinfo);
        free(rgba);
        free(rowbuf);
        return nullptr;
    }
    JSAMPROW rowp[1] = {rowbuf};
    for (int y = 0; y < h; ++y) {
        if (J->read_scanlines(&cinfo, rowp, 1) != 1) {
            longjmp(jerr.jb, 1);  // truncated: python path's error text
        }
        uint8_t *dst = rgba + (size_t)y * w * 4;
        if (oc == 3) {
            for (int x = 0; x < w; ++x) {
                dst[x * 4 + 0] = rowbuf[x * 3 + 0];
                dst[x * 4 + 1] = rowbuf[x * 3 + 1];
                dst[x * 4 + 2] = rowbuf[x * 3 + 2];
                dst[x * 4 + 3] = 255;
            }
        } else {
            for (int x = 0; x < w; ++x) {
                dst[x * 4 + 0] = rowbuf[x];
                dst[x * 4 + 1] = rowbuf[x];
                dst[x * 4 + 2] = rowbuf[x];
                dst[x * 4 + 3] = 255;
            }
        }
    }
    J->finish_decompress(&cinfo);
    const long warnings = jerr.mgr.num_warnings;
    J->destroy_decompress(&cinfo);
    free(rowbuf);
    if (warnings > 0) {  // corrupt-but-recoverable: let PIL arbitrate
        free(rgba);
        return nullptr;
    }
    *out_w = w;
    *out_h = h;
    return rgba;
}
#else   // no jpeglib.h: JPEGs exec the python launcher (PIL decodes them)
struct JpegApi {};
static JpegApi *jpeg_api() { return nullptr; }
static uint8_t *decode_jpeg_still(const uint8_t *, size_t, const Display &,
                                  int *, int *, int *, int *) {
    return nullptr;
}
#endif

// ---------------------------------------------------------------------
// GIF stills (fast._render_pil GIF-path mirror).
//
// PIL opens single-frame GIFs in mode "P" and convert("RGBA") applies
// the active palette (zero-padded to 256) with the GCE transparency
// index at alpha 0 -- fully deterministic, so a strict spec decoder
// reproduces PIL's bytes.  ANY anomaly (second image descriptor =
// animation, truncated LZW, out-of-screen frame box, missing palette)
// bails to the python launcher, which arbitrates exactly as PIL does.
// ---------------------------------------------------------------------
static bool gif_lzw_decode(const uint8_t *d, size_t len, size_t *pos,
                           int min_code_size, uint8_t *out, size_t need) {
    if (min_code_size < 2 || min_code_size > 11) return false;
    static const int kMax = 4096;
    int16_t prefix[4096];
    uint8_t suffix[4096];
    uint8_t stack[4096];
    const int clear_code = 1 << min_code_size;
    const int end_code = clear_code + 1;
    int code_size = min_code_size + 1;
    int next_code = end_code + 1;
    int prev = -1;
    uint32_t bits = 0;
    int nbits = 0;
    size_t written = 0;
    size_t p = *pos;
    bool done = false;

    // Expand `code` (known valid) onto the stack; returns the root
    // (first) character, or -1 on a corrupt chain.
    auto expand = [&](int code, int *sp) -> int {
        int e = code;
        *sp = 0;
        while (e >= clear_code + 2) {
            if (*sp >= kMax) return -1;
            stack[(*sp)++] = suffix[e];
            e = prefix[e];
        }
        return e < clear_code ? e : -1;
    };
    auto emit = [&](uint8_t v) {
        if (written < need) out[written] = v;
        ++written;
    };

    while (!done) {
        if (p >= len) return false;
        int block = d[p++];
        if (block == 0) break;  // terminator
        if (p + (size_t)block > len) return false;
        for (int i = 0; i < block && !done; ++i) {
            bits |= (uint32_t)d[p + i] << nbits;
            nbits += 8;
            while (nbits >= code_size) {
                const int code = (int)(bits & ((1u << code_size) - 1));
                bits >>= code_size;
                nbits -= code_size;
                if (code == clear_code) {
                    code_size = min_code_size + 1;
                    next_code = end_code + 1;
                    prev = -1;
                    continue;
                }
                if (code == end_code) {
                    done = true;
                    break;
                }
                int sp = 0;
                int first;
                if (prev < 0) {
                    if (code >= clear_code) return false;
                    emit((uint8_t)code);
                    prev = code;
                    continue;
                }
                if (code < next_code && code != clear_code &&
                    code != end_code) {
                    first = expand(code, &sp);
                    if (first < 0) return false;
                } else if (code == next_code && next_code < kMax) {
                    // KwKwK: string(prev) + first(string(prev))
                    first = expand(prev, &sp);
                    if (first < 0) return false;
                    // push first(prev) so it pops last
                    if (sp >= kMax) return false;
                    // shift: stack pops in reverse, so prepend by
                    // inserting at position 0
                    memmove(stack + 1, stack, (size_t)sp);
                    stack[0] = (uint8_t)first;
                    ++sp;
                } else {
                    return false;
                }
                emit((uint8_t)first);
                while (sp > 0) emit(stack[--sp]);
                if (next_code < kMax) {
                    prefix[next_code] = (int16_t)prev;
                    suffix[next_code] = (uint8_t)first;
                    ++next_code;
                    if (next_code == (1 << code_size) && code_size < 12)
                        ++code_size;
                }
                prev = code;
                if (written >= need) {
                    done = true;  // frame full: PIL stops here too
                    break;
                }
            }
        }
        p += (size_t)block;
    }
    if (written < need) return false;  // truncated stream
    while (p < len && d[p] != 0) {     // skip remaining sub-blocks
        size_t b = d[p];
        if (p + 1 + b > len) return false;
        p += 1 + b;
    }
    if (p >= len) return false;
    ++p;  // terminator
    *pos = p;
    return true;
}

// Pillow-equivalent GIF decode, stills AND animations.  Mirrors
// GifImagePlugin (_open/_seek/load_prepare/load_end, strategy
// RGB_AFTER_FIRST) frame for frame:
//  * frame 0 decodes into a P canvas initialized to the GCE
//    transparency index (else 0); emitted via the zero-padded palette
//    with that index at alpha 0;
//  * before frame 1 the canvas converts to RGBA (frame-0 transparency
//    consumed) or RGB;
//  * dispose ops are computed at "seek" time (before the frame
//    paints): method 2 fills the frame extent with transparency-first
//    color (alpha 0 on RGB(A) canvases), method 3 restores the
//    pre-frame region (at frame 0: a transparency fill, Pillow quirk);
//    the disposal method is sticky across GCEs with dispose bits 0;
//  * frames >= 1 decode into a fresh P buffer filled with their own
//    transparency index and paste masked (transparent source pixels
//    keep the canvas).
// Grayscale-identity palettes (Pillow's L-mode path), frames exceeding
// the logical screen (canvas expansion) or any stream anomaly -> bail.
struct GifFrame {
    std::vector<uint8_t> rgba;
    double delay_ms = 0.0;
};

static bool gif_palette_identity(const uint8_t *p, int n) {
    for (int i = 0; i < n; ++i)
        if (!(p[i * 3] == i && p[i * 3 + 1] == i && p[i * 3 + 2] == i))
            return false;
    return true;
}

static bool decode_gif(const uint8_t *d, size_t len,
                       std::vector<GifFrame> *frames, int *out_w,
                       int *out_h) {
    if (len < 13) return false;
    if (memcmp(d, "GIF87a", 6) != 0 && memcmp(d, "GIF89a", 6) != 0)
        return false;
    const int sw = d[6] | (d[7] << 8);
    const int sh = d[8] | (d[9] << 8);
    if (sw <= 0 || sh <= 0 || (long)sw * sh > (1L << 28)) return false;
    const uint8_t flags = d[10];
    size_t p = 13;
    const uint8_t *gct = nullptr;
    int gct_n = 0;
    int background = -1;  // info["background"] only with a GCT
    if (flags & 0x80) {
        gct_n = 2 << (flags & 7);
        if (p + (size_t)gct_n * 3 > len) return false;
        gct = d + p;
        background = d[11];
        if (gif_palette_identity(gct, gct_n)) return false;  // L-mode
        p += (size_t)gct_n * 3;
    }

    const size_t npx = (size_t)sw * sh;
    std::vector<uint8_t> canvasP;     // frame-0 phase (P indices)
    std::vector<uint8_t> canvasRGBA;  // after the mode transition

    int info_transparency = -1;  // frame 0's GCE transparency (sticky
                                 // until the mode transition consumes it)
    int disposal_method = 0;     // sticky across GCEs with bits 0
    // Pending dispose op, applied before the NEXT frame decodes.
    enum { D_NONE, D_FILL_P, D_FILL_RGBA, D_RESTORE } dk = D_NONE;
    int d_x0 = 0, d_y0 = 0, d_x1 = 0, d_y1 = 0;
    uint8_t d_fill[4] = {0, 0, 0, 0};
    uint8_t d_fill_p = 0;
    std::vector<uint8_t> d_saved;  // RESTORE region (RGBA) / P at f0
    bool d_saved_p = false;

    int gce_trans = -1;
    double gce_duration = -1.0;
    int frame_no = 0;
    const uint8_t *pal0 = nullptr;
    int pal0_n = 0;

    while (p < len) {
        const uint8_t b = d[p];
        if (b == 0x3B) break;  // trailer
        if (b == 0x21) {       // extension
            if (p + 2 > len) return false;
            const uint8_t label = d[p + 1];
            p += 2;
            if (label == 0xF9) {
                if (p >= len || d[p] < 4 || p + 1 + d[p] > len)
                    return false;
                const uint8_t *gce = d + p + 1;
                gce_trans = (gce[0] & 1) ? gce[3] : -1;
                gce_duration = (double)(gce[1] | (gce[2] << 8)) * 10.0;
                const int bits = (gce[0] >> 2) & 7;
                if (bits) disposal_method = bits;  // sticky (Pillow)
            }
            while (p < len && d[p] != 0) {
                size_t sb = d[p];
                if (p + 1 + sb > len) return false;
                p += 1 + sb;
            }
            if (p >= len) return false;
            ++p;
            continue;
        }
        if (b != 0x2C) return false;  // unknown block
        // ---- image descriptor ----
        if (p + 10 > len) return false;
        const int left = d[p + 1] | (d[p + 2] << 8);
        const int top = d[p + 3] | (d[p + 4] << 8);
        const int fw = d[p + 5] | (d[p + 6] << 8);
        const int fh = d[p + 7] | (d[p + 8] << 8);
        const uint8_t iflags = d[p + 9];
        p += 10;
        if (fw <= 0 || fh <= 0 || left + fw > sw || top + fh > sh)
            return false;  // canvas expansion: python path
        const uint8_t *pal = gct;
        int pal_n = gct_n;
        if (iflags & 0x80) {
            pal_n = 2 << (iflags & 7);
            if (p + (size_t)pal_n * 3 > len) return false;
            pal = d + p;
            if (gif_palette_identity(pal, pal_n)) return false;
            p += (size_t)pal_n * 3;
        }
        if (!pal) return false;
        if (p >= len) return false;
        const int min_code = d[p++];
        const int ft = gce_trans;
        const double delay =
            gce_duration >= 0 ? gce_duration : 0.0;  // no GCE: 0 -> 100
        gce_trans = -1;
        gce_duration = -1.0;

        // Pillow's _rgb(): palette clamp to index 0 when out of range.
        auto pal_rgb = [&](int idx, uint8_t *rgb) {
            if (idx < 0 || idx >= pal_n) idx = 0;  // Pillow _rgb clamp
            rgb[0] = pal[idx * 3];
            rgb[1] = pal[idx * 3 + 1];
            rgb[2] = pal[idx * 3 + 2];
        };

        if (frame_no == 0) {
            pal0 = pal;
            pal0_n = pal_n;
            info_transparency = ft;
            canvasP.assign(npx, (uint8_t)(ft >= 0 ? ft : 0));
        } else {
            if (frame_no == 1) {
                // seek(1): apply frame 0's dispose in P space, then
                // the P -> RGB(A) transition with frame 0's palette.
                if (dk == D_FILL_P) {
                    for (int y = d_y0; y < d_y1; ++y)
                        memset(&canvasP[(size_t)y * sw + d_x0], d_fill_p,
                               (size_t)(d_x1 - d_x0));
                } else if (dk == D_RESTORE && d_saved_p) {
                    for (int y = d_y0; y < d_y1; ++y)
                        memcpy(&canvasP[(size_t)y * sw + d_x0],
                               &d_saved[(size_t)(y - d_y0) * (d_x1 - d_x0)],
                               (size_t)(d_x1 - d_x0));
                }
                uint8_t lut[256][4];
                memset(lut, 0, sizeof(lut));
                for (int i = 0; i < 256; ++i) {
                    if (i < pal0_n) {
                        lut[i][0] = pal0[i * 3];
                        lut[i][1] = pal0[i * 3 + 1];
                        lut[i][2] = pal0[i * 3 + 2];
                    }
                    lut[i][3] = 255;
                }
                if (info_transparency >= 0)
                    lut[info_transparency][3] = 0;
                canvasRGBA.resize(npx * 4);
                for (size_t i = 0; i < npx; ++i)
                    memcpy(&canvasRGBA[i * 4], lut[canvasP[i]], 4);
                info_transparency = -1;  // del info["transparency"]
            } else {
                // apply the pending dispose on the RGB(A) canvas
                if (dk == D_FILL_RGBA) {
                    for (int y = d_y0; y < d_y1; ++y)
                        for (int x = d_x0; x < d_x1; ++x)
                            memcpy(&canvasRGBA[((size_t)y * sw + x) * 4],
                                   d_fill, 4);
                } else if (dk == D_RESTORE && !d_saved_p) {
                    for (int y = d_y0; y < d_y1; ++y)
                        memcpy(&canvasRGBA[((size_t)y * sw + d_x0) * 4],
                               &d_saved[(size_t)(y - d_y0) *
                                        (d_x1 - d_x0) * 4],
                               (size_t)(d_x1 - d_x0) * 4);
                }
            }
        }
        dk = D_NONE;

        // Compute THIS frame's dispose now -- "seek" time, before the
        // frame paints (method 3 must restore the pre-frame canvas).
        if (disposal_method >= 2) {
            d_x0 = left;
            d_y0 = top;
            d_x1 = left + fw;
            d_y1 = top + fh;
            if (disposal_method == 2) {
                if (frame_no == 0) {
                    const int color = info_transparency >= 0
                                          ? info_transparency
                                          : (background >= 0 ? background
                                                             : 0);
                    dk = D_FILL_P;
                    d_fill_p = (uint8_t)color;
                } else {
                    dk = D_FILL_RGBA;
                    if (ft >= 0) {
                        pal_rgb(ft, d_fill);
                        d_fill[3] = 0;
                    } else {
                        pal_rgb(background >= 0 ? background : 0, d_fill);
                        d_fill[3] = 255;
                    }
                }
            } else {  // method 3: restore previous
                if (frame_no == 0) {
                    // Pillow quirk: no canvas yet -> transparency fill
                    // (or no dispose at all without transparency).
                    if (ft >= 0) {
                        dk = D_FILL_P;
                        d_fill_p = (uint8_t)ft;
                    }
                } else {
                    dk = D_RESTORE;
                    d_saved_p = false;
                    d_saved.resize((size_t)(d_x1 - d_x0) *
                                   (d_y1 - d_y0) * 4);
                    for (int y = d_y0; y < d_y1; ++y)
                        memcpy(&d_saved[(size_t)(y - d_y0) *
                                        (d_x1 - d_x0) * 4],
                               &canvasRGBA[((size_t)y * sw + d_x0) * 4],
                               (size_t)(d_x1 - d_x0) * 4);
                }
            }
        }

        // ---- decode the frame's LZW data ----
        std::vector<uint8_t> idx((size_t)fw * fh);
        {
            // region decodes into a buffer pre-filled with the frame's
            // transparency index (load_prepare's fresh P fill); for
            // frame 0 the fill only matters if LZW underruns -> bail.
            if (!gif_lzw_decode(d, len, &p, min_code, idx.data(),
                                idx.size()))
                return false;
        }
        auto blit_rows = [&](std::vector<uint8_t> &dst) {
            if (iflags & 0x40) {  // interlaced
                static const int istart[4] = {0, 4, 2, 1};
                static const int istep[4] = {8, 8, 4, 2};
                int src = 0;
                for (int pass = 0; pass < 4; ++pass)
                    for (int y = istart[pass]; y < fh; y += istep[pass])
                        memcpy(&dst[(size_t)(top + y) * sw + left],
                               &idx[(size_t)(src++) * fw], (size_t)fw);
            } else {
                for (int y = 0; y < fh; ++y)
                    memcpy(&dst[(size_t)(top + y) * sw + left],
                           &idx[(size_t)y * fw], (size_t)fw);
            }
        };

        GifFrame out_frame;
        out_frame.delay_ms = delay;
        if (frame_no == 0) {
            blit_rows(canvasP);
            uint8_t lut[256][4];
            memset(lut, 0, sizeof(lut));
            for (int i = 0; i < 256; ++i) {
                if (i < pal_n) {
                    lut[i][0] = pal[i * 3];
                    lut[i][1] = pal[i * 3 + 1];
                    lut[i][2] = pal[i * 3 + 2];
                }
                lut[i][3] = 255;
            }
            if (ft >= 0) lut[ft][3] = 0;
            out_frame.rgba.resize(npx * 4);
            for (size_t i = 0; i < npx; ++i)
                memcpy(&out_frame.rgba[i * 4], lut[canvasP[i]], 4);
        } else {
            // load_end: paste the frame region, transparent source
            // pixels keeping the canvas.
            uint8_t lut[256][4];
            memset(lut, 0, sizeof(lut));
            for (int i = 0; i < 256; ++i) {
                if (i < pal_n) {
                    lut[i][0] = pal[i * 3];
                    lut[i][1] = pal[i * 3 + 1];
                    lut[i][2] = pal[i * 3 + 2];
                }
                lut[i][3] = 255;
            }
            if (ft >= 0) lut[ft][3] = 0;
            // deinterlace within the region
            std::vector<uint8_t> region((size_t)fw * fh);
            if (iflags & 0x40) {
                static const int istart[4] = {0, 4, 2, 1};
                static const int istep[4] = {8, 8, 4, 2};
                int src = 0;
                for (int pass = 0; pass < 4; ++pass)
                    for (int y = istart[pass]; y < fh; y += istep[pass])
                        memcpy(&region[(size_t)y * fw],
                               &idx[(size_t)(src++) * fw], (size_t)fw);
            } else {
                region = idx;
            }
            for (int y = 0; y < fh; ++y) {
                for (int x = 0; x < fw; ++x) {
                    const uint8_t ci = region[(size_t)y * fw + x];
                    if (ft >= 0 && ci == (uint8_t)ft) continue;  // mask
                    memcpy(&canvasRGBA[((size_t)(top + y) * sw + left +
                                        x) * 4],
                           lut[ci], 4);
                }
            }
            out_frame.rgba = canvasRGBA;
        }
        frames->push_back(std::move(out_frame));
        ++frame_no;
        if (frame_no > 4096) return false;  // runaway stream
        // Decoded-bytes budget: each frame stores a full-canvas RGBA
        // copy, so a tiny crafted GIF (huge screen x many frames) can
        // demand terabytes.  Bail to the python path at 512 MiB.
        if ((uint64_t)frame_no * npx * 4 > (1ULL << 29)) return false;
    }
    if (frame_no == 0) return false;
    *out_w = sw;
    *out_h = sh;
    return true;
}

// BMP stills (PIL BmpImagePlugin raw-tile mirror for the common
// subset): "BM" + 40-byte BITMAPINFOHEADER, BI_RGB, 8-bit palette or
// 24-bit BGR, bottom-up or top-down, 4-byte row alignment.  Everything
// else (1/4/16/32-bit, RLE, bitfields, V4/V5 headers) bails -- PIL
// handles those on the python path (32-bit BGRX deliberately so:
// fast.py's numpy-mirror rewire owns it).
static uint8_t *decode_bmp_still(const uint8_t *d, size_t len, int *out_w,
                                 int *out_h) {
    auto r16 = [&](size_t o) { return (int)(d[o] | (d[o + 1] << 8)); };
    auto r32 = [&](size_t o) {
        return (long)((unsigned long)d[o] | ((unsigned long)d[o + 1] << 8) |
                      ((unsigned long)d[o + 2] << 16) |
                      ((unsigned long)d[o + 3] << 24));
    };
    if (len < 54 || d[0] != 'B' || d[1] != 'M') return nullptr;
    const long pixel_off = r32(10);
    const long dib = r32(14);
    if (dib != 40) return nullptr;  // V2-V5 etc: python path
    const long w = r32(18);
    long h = r32(22);
    bool bottom_up = true;
    if (h < 0) {
        bottom_up = false;
        h = -h;
    }
    const int planes = r16(26);
    const int bpp = r16(28);
    const long comp = r32(30);
    long colors_used = r32(46);
    if (planes != 1 || comp != 0 || (bpp != 8 && bpp != 24))
        return nullptr;
    // r32 yields full unsigned 32-bit values; bound each dimension
    // BEFORE any product so w*h / stride*h / pixel_off+stride*h can
    // never overflow even in uint64 (hostile-BMP hardening).
    if (w <= 0 || h <= 0 || w > (1L << 24) || h > (1L << 24))
        return nullptr;
    if ((uint64_t)w * (uint64_t)h > (1ULL << 28)) return nullptr;
    uint8_t pal[256][4];
    if (bpp == 8) {
        if (colors_used <= 0 || colors_used > 256) colors_used = 256;
        if (54 + colors_used * 4 > (long)len) return nullptr;
        memset(pal, 0, sizeof(pal));
        for (long i = 0; i < colors_used; ++i) {
            pal[i][0] = d[54 + i * 4 + 2];  // BGRX entries
            pal[i][1] = d[54 + i * 4 + 1];
            pal[i][2] = d[54 + i * 4 + 0];
            pal[i][3] = 255;
        }
        for (long i = colors_used; i < 256; ++i) pal[i][3] = 255;
    }
    const long stride = ((w * bpp + 31) / 32) * 4;
    if (pixel_off < 0 ||
        (uint64_t)pixel_off + (uint64_t)stride * (uint64_t)h >
            (uint64_t)len)
        return nullptr;
    uint8_t *rgba = (uint8_t *)malloc((size_t)w * (size_t)h * 4);
    if (!rgba) return nullptr;
    for (long y = 0; y < h; ++y) {
        const uint8_t *row =
            d + pixel_off + (bottom_up ? (h - 1 - y) : y) * stride;
        uint8_t *dst = rgba + (size_t)y * w * 4;
        if (bpp == 24) {
            for (long x = 0; x < w; ++x) {
                dst[x * 4 + 0] = row[x * 3 + 2];
                dst[x * 4 + 1] = row[x * 3 + 1];
                dst[x * 4 + 2] = row[x * 3 + 0];
                dst[x * 4 + 3] = 255;
            }
        } else {
            for (long x = 0; x < w; ++x)
                memcpy(dst + x * 4, pal[row[x]], 4);
        }
    }
    *out_w = (int)w;
    *out_h = (int)h;
    return rgba;
}

enum StillKind { K_PNG, K_JPEG, K_GIF, K_BMP };

static bool prep_anim_frame(AnimFrame *afp, const uint8_t *rgba, int tw,
                            int th, const Display &disp, BgCache *bgc,
                            const char *bg_color);

// Animation processing: resize+compose every GIF canvas frame (one
// batched polyphase call), then per-mode prep (block planes or the
// composed RGBA for kitty).  Mirrors pil_source._process_frames +
// base.send_frames's per-frame geometry.
static bool render_gif_animation(std::vector<GifFrame> &gframes, int sw,
                                 int sh, const Display &disp, BgCache *bgc,
                                 const char *bg_color, Planes *out) {
    const int F = (int)gframes.size();
    int tw = 0, th = 0;
    timg_calc_scale(sw, sh, disp.width, disp.height,
                    disp.fill_width ? 1 : 0, disp.fill_height ? 1 : 0,
                    disp.width_stretch,
                    disp.upscale ? 1 : 0, disp.upscale_integer ? 1 : 0,
                    disp.cell_x, disp.cell_y, 0, &tw, &th);
    if (disp.quarter && (tw % 2)) return false;
    out->target_w = tw;
    out->target_h = th;
    // Batched resize (one call over all frames, like resize_batch_np).
    std::vector<uint8_t> stack;
    const size_t in_px = (size_t)sw * sh * 4;
    const size_t out_px = (size_t)tw * th * 4;
    std::vector<uint8_t> resized((size_t)F * out_px);
    if (sh != th || sw != tw) {
        stack.resize((size_t)F * in_px);
        for (int f = 0; f < F; ++f)
            memcpy(&stack[(size_t)f * in_px], gframes[f].rgba.data(),
                   in_px);
        if (!disp.antialias) {
            for (int f = 0; f < F; ++f)
                timg_resize_nearest(&stack[(size_t)f * in_px], sh, sw,
                                    &resized[(size_t)f * out_px], th, tw);
        } else {
            int32_t *sv = nullptr, *sx = nullptr;
            float *cv = nullptr, *cx = nullptr;
            const int wv = timg_build_taps(sh, th, 0, &sv, &cv);
            const int wh = timg_build_taps(sw, tw, 1, &sx, &cx);
            long rc = -1;
            if (wv >= 1 && wh >= 1) {
                const int vf = timg_plan_passes(sh, sw, th, tw, 1);
                rc = timg_resize_polyphase(stack.data(), F, sh, sw,
                                           resized.data(), th, tw, sv, cv,
                                           wv, sx, cx, wh, vf, 1);
            }
            timg_buf_free(sv);
            timg_buf_free(cv);
            timg_buf_free(sx);
            timg_buf_free(cx);
            if (rc != 0) return false;
        }
    } else {
        for (int f = 0; f < F; ++f)
            memcpy(&resized[(size_t)f * out_px], gframes[f].rgba.data(),
                   out_px);
    }
    // Lazy background compose: ANY translucent frame composes the
    // whole batch (pil_source._resize_compose).
    bool translucent = false;
    for (int f = 0; f < F && !translucent; ++f)
        if (timg_has_translucency(&resized[(size_t)f * out_px],
                                  (long)tw * th))
            translucent = true;
    if (translucent) {
        RGBA bg = bg_get(bgc, bg_color);
        if (bg.a != 0) {
            const int pw = (int)(disp.pattern_size * disp.cell_x);
            const int ph = (int)(disp.pattern_size * disp.cell_y / 2);
            uint8_t bg4[4] = {bg.r, bg.g, bg.b, bg.a};
            uint8_t pat4[4] = {disp.bg_pattern_color.r,
                               disp.bg_pattern_color.g,
                               disp.bg_pattern_color.b,
                               disp.bg_pattern_color.a};
            for (int f = 0; f < F; ++f)
                timg_alpha_over_bg(&resized[(size_t)f * out_px], th, tw,
                                   bg4, pat4, pw, ph, 0);
        }
    }
    out->anim.resize((size_t)F);
    for (int f = 0; f < F; ++f) {
        AnimFrame &af = out->anim[(size_t)f];
        af.delay_ms = gframes[(size_t)f].delay_ms < 10.0
                          ? 100.0
                          : gframes[(size_t)f].delay_ms;
        if (!prep_anim_frame(&af, &resized[(size_t)f * out_px], tw, th,
                             disp, bgc, bg_color))
            return false;
    }
    return true;
}

// Per-mode frame prep for an already resized+composed RGBA frame:
// block planes, sixel bucket-table DCS stream, or the raw frame for
// kitty/iTerm2.  Shared by GIF animations and scroll.
static bool prep_anim_frame(AnimFrame *afp, const uint8_t *rgba, int tw,
                            int th, const Display &disp, BgCache *bgc,
                            const char *bg_color) {
    AnimFrame &af = *afp;
    const size_t out_px = (size_t)tw * th * 4;
    {
        if (disp.mode == Display::KITTY ||
            disp.mode == Display::ITERM2) {
            af.frame.assign(rgba, rgba + out_px);
            return true;
        }
        if (disp.mode == Display::SIXEL) {
            // Animation frames run the order-independent bucket-table
            // pipeline, byte-consistent with the batched device path
            // (sixel_render._enqueue_libsixel's animation branch /
            // plane_cache._prime_libsixel).
            const int padded_h = (th + 5) - (th + 5) % 6;
            std::vector<uint8_t> buf(rgba, rgba + out_px);
            if (padded_h > th) {
                RGBA bg = bg_get(bgc, bg_color);
                const size_t extra = (size_t)(padded_h - th) * tw;
                if (bg.a != 0) {
                    uint8_t px[4] = {bg.r, bg.g, bg.b, 255};
                    buf.reserve(buf.size() + extra * 4);
                    for (size_t i = 0; i < extra; ++i)
                        buf.insert(buf.end(), px, px + 4);
                } else {
                    buf.insert(buf.end(), extra * 4, 0);
                }
            }
            std::vector<uint8_t> pal(256 * 3);
            const int pr = timg_libsixel_palette(buf.data(), padded_h, tw,
                                                 (long)tw * 4, 256,
                                                 pal.data());
            if (pr < 0) return false;
            const int ncolors = pr & 0xFFFF;
            const int diffuse = pr >> 16;
            std::vector<uint8_t> table(1 << 15);
            timg_libsixel_build_table(pal.data(), ncolors, table.data());
            std::vector<uint8_t> sidx((size_t)padded_h * tw);
            if (timg_libsixel_apply_table(buf.data(), padded_h, tw,
                                          (long)tw * 4, table.data(),
                                          pal.data(), diffuse,
                                          sidx.data()) != 0)
                return false;
            const long n_bands = (padded_h + 5) / 6;
            const size_t cap = (size_t)n_bands * ncolors * (tw + 12) +
                               ncolors * 20 + 256;
            // new char[] stays uninitialized: the vector's zero-fill
            // of this multi-MB bound was ~half the assembly stage.
            std::unique_ptr<char[]> six(new char[cap]);
            const long sn = timg_sixel_encode(sidx.data(), padded_h, tw,
                                              tw, pal.data(), ncolors,
                                              six.get());
            if (sn < 0) return false;
            af.sixel_stream.assign(six.get(), (size_t)sn);
            return true;
        }
        // block planes (odd-height pad + argmin), ansi.send mirror
        std::vector<uint8_t> padded(rgba, rgba + out_px);
        int padded_h = th;
        if (th % 2) {
            const size_t row = (size_t)tw * 4;
            if (disp.use_upper)
                padded.insert(padded.end(), row, 0);
            else
                padded.insert(padded.begin(), row, 0);
            padded_h += 1;
        }
        const int hcells = padded_h / 2;
        const int wcells = disp.quarter ? tw / 2 : tw;
        af.glyph.resize((size_t)hcells * wcells);
        af.fg.resize((size_t)hcells * wcells * 4);
        af.bg.resize((size_t)hcells * wcells * 4);
        if (disp.quarter)
            timg_quarter_blocks(padded.data(), padded_h, tw,
                                disp.use_upper ? 1 : 0, af.glyph.data(),
                                af.fg.data(), af.bg.data());
        else
            timg_half_blocks(padded.data(), padded_h, tw,
                             disp.use_upper ? 1 : 0, af.glyph.data(),
                             af.fg.data(), af.bg.data());
        af.hcells = hcells;
        af.wcells = wcells;
        af.padded_h = padded_h;
        af.padded = std::move(padded);
    }
    return true;
}

// Scroll: wraparound pan crops over the processed frame
// (sources/scroll.py mirror; ref graphics-magick-source.cc:326-399).
// The python path streams 16-step windows through the device; here the
// cycle is prebuilt (bounded) and each crop preps like an animation
// frame.
static bool render_scroll(const uint8_t *img, int img_h, int img_w,
                          const Display &disp, BgCache *bgc,
                          const char *bg_color, Planes *out) {
    const int display_w = disp.width < img_w ? disp.width : img_w;
    const int display_h = disp.height < img_h ? disp.height : img_h;
    if (display_w <= 0 || display_h <= 0) return false;
    if (disp.quarter && (display_w % 2)) return false;
    const int dx = disp.scroll_dx, dy = disp.scroll_dy;
    auto steps_for_axis = [](int size, int delta) -> long {
        if (delta == 0) return 1;
        const int a = delta < 0 ? -delta : delta;
        return size % a == 0 ? size / a : size;
    };
    const long x_steps = steps_for_axis(img_w, dx);
    const long y_steps = steps_for_axis(img_h, dy);
    long g = x_steps, b = y_steps;
    while (b) {
        const long t = g % b;
        g = b;
        b = t;
    }
    const long cycle = x_steps * y_steps / g;
    if (cycle + 1 > 4096) return false;  // python path streams these
    const long x_init = dx < 0 ? (img_w - display_w - dx * cycle) : 0;
    const long y_init = dy < 0 ? (img_h - display_h - dy * cycle) : 0;
    auto fmod_i = [](long a, long m) { return (int)(((a % m) + m) % m); };
    out->scroll = true;
    out->scroll_delay_ms = disp.scroll_delay_ms;
    out->target_w = display_w;
    out->target_h = display_h;
    out->anim.resize((size_t)cycle + 1);
    std::vector<uint8_t> crop((size_t)display_h * display_w * 4);
    for (long k = 0; k <= cycle; ++k) {
        for (int r = 0; r < display_h; ++r) {
            const int sy = fmod_i(y_init + (long)dy * k + r, img_h);
            const uint8_t *src = img + (size_t)sy * img_w * 4;
            uint8_t *dst = crop.data() + (size_t)r * display_w * 4;
            const int sx = fmod_i(x_init + (long)dx * k, img_w);
            const int first = display_w < img_w - sx ? display_w
                                                     : img_w - sx;
            memcpy(dst, src + (size_t)sx * 4, (size_t)first * 4);
            if (first < display_w)
                memcpy(dst + (size_t)first * 4, src,
                       (size_t)(display_w - first) * 4);
        }
        AnimFrame &af = out->anim[(size_t)k];
        af.delay_ms = disp.scroll_delay_ms;
        if (!prep_anim_frame(&af, crop.data(), display_w, display_h,
                             disp, bgc, bg_color))
            return false;
    }
    return true;
}

// Returns false -> outside the envelope (exec fallback).
static bool render_still(const char *fname, StillKind kind,
                         bool allow_anim, const Display &disp,
                         BgCache *bgc, const char *bg_color, Planes *out) {
    FILE *f = fopen(fname, "rb");
    if (!f) return false;
    std::string data;
    char buf[65536];
    size_t n;
    while ((n = fread(buf, 1, sizeof(buf), f)) > 0) data.append(buf, n);
    bool rerr = ferror(f);
    fclose(f);
    if (rerr) return false;

    uint8_t *rgba = nullptr;
    uint8_t *png_raw = nullptr;  // fused decode->resize arena (PNG 2/6)
    int png_color = 0;
    int iw = 0, ih = 0, flags = 0;
    stage("read");
    if (kind == K_JPEG) {
        int true_w = 0, true_h = 0;
        rgba = decode_jpeg_still((const uint8_t *)data.data(), data.size(),
                                 disp, &iw, &ih, &true_w, &true_h);
        if (!rgba) return false;
        // Titles report the file's real dimensions even when the
        // decode was DCT-drafted (fast.py _true_orig).
        flags = 0;
        out->orig_w = true_w;
        out->orig_h = true_h;
    } else if (kind == K_GIF) {
        std::vector<GifFrame> gframes;
        if (!decode_gif((const uint8_t *)data.data(), data.size(),
                        &gframes, &iw, &ih))
            return false;
        flags = 0;
        out->orig_w = iw;
        out->orig_h = ih;
        if (gframes.size() > 1) {
            if (!allow_anim || disp.scroll_on) return false;
            return render_gif_animation(gframes, iw, ih, disp, bgc,
                                        bg_color, out);
        }
        rgba = (uint8_t *)malloc(gframes[0].rgba.size());
        if (!rgba) return false;
        memcpy(rgba, gframes[0].rgba.data(), gframes[0].rgba.size());
    } else if (kind == K_BMP) {
        rgba = decode_bmp_still((const uint8_t *)data.data(), data.size(),
                                &iw, &ih);
        if (!rgba) return false;
        flags = 0;
        out->orig_w = iw;
        out->orig_h = ih;
    } else if (timg_png_decode_raw((const uint8_t *)data.data(),
                                   (long)data.size(), &png_raw, &iw, &ih,
                                   &png_color, &flags) == 0) {
        // Fused path: raw unfiltered scanlines feed the resize executor
        // directly (no 33 MB RGBA plane at 4K).  Cases that need the
        // RGBA plane after all fall back below at the decision point.
    } else if (timg_png_decode((const uint8_t *)data.data(),
                               (long)data.size(), &rgba, &iw, &ih,
                               &flags) != 0) {
        return false;
    }
    stage("decode");
    bool ok = false;
    do {
        if (flags & 1) break;                       // APNG -> video path
        if (disp.exif_rotate && (flags & 2)) break; // eXIf present
        if (kind == K_PNG) {
            out->orig_w = iw;
            out->orig_h = ih;
        }
        int tw = 0, th = 0;
        timg_calc_scale(iw, ih, disp.width, disp.height,
                        disp.fill_width ? 1 : 0, disp.fill_height ? 1 : 0,
                    disp.width_stretch,
                        disp.upscale ? 1 : 0, disp.upscale_integer ? 1 : 0,
                        disp.cell_x, disp.cell_y, 0, &tw, &th);
        if (disp.quarter && (tw % 2)) break;  // odd-width overrun case
        if (png_raw && (!disp.antialias || (ih == th && iw == tw))) {
            // Nearest/same-size consume an RGBA plane: leave the fused
            // path and decode normally (small images; the re-parse is
            // cheap next to the 4K case the fusion exists for).
            timg_buf_free(png_raw);
            png_raw = nullptr;
            int flags2 = 0;
            if (timg_png_decode((const uint8_t *)data.data(),
                                (long)data.size(), &rgba, &iw, &ih,
                                &flags2) != 0)
                break;
        }
        std::vector<uint8_t> frame((size_t)th * tw * 4);
        if (ih != th || iw != tw) {
            if (!disp.antialias) {
                timg_resize_nearest(rgba, ih, iw, frame.data(), th, tw);
            } else {
                int32_t *starts_v = nullptr, *starts_h = nullptr;
                float *coeffs_v = nullptr, *coeffs_h = nullptr;
                int widest_v = timg_build_taps(ih, th, 0, &starts_v,
                                               &coeffs_v);
                int widest_h = timg_build_taps(iw, tw, 1, &starts_h,
                                               &coeffs_h);
                long rc = -1;
                if (widest_v >= 1 && widest_h >= 1) {
                    int vfirst = timg_plan_passes(ih, iw, th, tw, 1);
                    if (png_raw) {
                        const int bpp = (png_color == 2) ? 3 : 4;
                        rc = timg_resize_polyphase_src(
                            png_raw + 1, (long)iw * bpp + 1,
                            png_color == 2 ? 1 : 0, 1, ih, iw,
                            frame.data(), th, tw, starts_v, coeffs_v,
                            widest_v, starts_h, coeffs_h, widest_h,
                            vfirst, 1);
                    } else {
                        rc = timg_resize_polyphase(
                            rgba, 1, ih, iw, frame.data(), th, tw,
                            starts_v, coeffs_v, widest_v, starts_h,
                            coeffs_h, widest_h, vfirst, 1);
                    }
                }
                timg_buf_free(starts_v);
                timg_buf_free(coeffs_v);
                timg_buf_free(starts_h);
                timg_buf_free(coeffs_h);
                if (rc != 0) break;
            }
        } else {
            memcpy(frame.data(), rgba, (size_t)th * tw * 4);
        }
        stage("resize");

        // Lazy background compose (ref framebuffer.cc:113-121).
        if (timg_has_translucency(frame.data(), (long)th * tw)) {
            RGBA bg = bg_get(bgc, bg_color);
            if (bg.a != 0) {
                int pw = (int)(disp.pattern_size * disp.cell_x);
                int ph = (int)(disp.pattern_size * disp.cell_y / 2);
                uint8_t bg4[4] = {bg.r, bg.g, bg.b, bg.a};
                uint8_t pat4[4] = {disp.bg_pattern_color.r,
                                   disp.bg_pattern_color.g,
                                   disp.bg_pattern_color.b,
                                   disp.bg_pattern_color.a};
                timg_alpha_over_bg(frame.data(), th, tw, bg4, pat4, pw, ph,
                                   0);
            }
        }
        out->target_w = tw;
        out->target_h = th;

        if (disp.scroll_on) {
            ok = render_scroll(frame.data(), th, tw, disp, bgc, bg_color,
                               out);
            break;
        }

        if (disp.mode == Display::SIXEL || disp.mode == Display::KITTY ||
            disp.mode == Display::ITERM2) {
            out->frame = std::move(frame);
            ok = true;
            break;
        }

        // Odd-height empty-line shift (ref unicode-block-canvas.cc:
        // 356-365): append when TIMG_USE_UPPER_BLOCK, else prepend.
        int padded_h = th;
        if (th % 2) {
            size_t row = (size_t)tw * 4;
            if (disp.use_upper)
                frame.insert(frame.end(), row, 0);
            else
                frame.insert(frame.begin(), row, 0);
            padded_h += 1;
        }
        int hcells = padded_h / 2;
        int wcells = disp.quarter ? tw / 2 : tw;
        out->glyph.resize((size_t)hcells * wcells);
        out->fg.resize((size_t)hcells * wcells * 4);
        out->bg.resize((size_t)hcells * wcells * 4);
        if (disp.quarter)
            timg_quarter_blocks(frame.data(), padded_h, tw,
                                disp.use_upper ? 1 : 0, out->glyph.data(),
                                out->fg.data(), out->bg.data());
        else
            timg_half_blocks(frame.data(), padded_h, tw,
                             disp.use_upper ? 1 : 0, out->glyph.data(),
                             out->fg.data(), out->bg.data());
        stage("blocks");
        out->hcells = hcells;
        out->wcells = wcells;
        out->is_blocks = true;
        ok = true;
    } while (false);
    timg_buf_free(rgba);
    timg_buf_free(png_raw);
    return ok;
}

// fast._sixel_payload mirror: pad height to %6 with a bg strip, then
// the reference-exact libsixel quant.c pipeline + RLE assembly.
static bool sixel_payload(const std::vector<uint8_t> &frame, int w, int h,
                          BgCache *bgc, const char *bg_color,
                          std::string *out) {
    int padded_h = (h + 5) - (h + 5) % 6;
    std::vector<uint8_t> buf(frame.begin(),
                             frame.begin() + (size_t)h * w * 4);
    if (padded_h > h) {
        RGBA bg = bg_get(bgc, bg_color);
        size_t extra = (size_t)(padded_h - h) * w;
        if (bg.a != 0) {
            uint8_t px[4] = {bg.r, bg.g, bg.b, 255};
            buf.reserve(buf.size() + extra * 4);
            for (size_t i = 0; i < extra; ++i)
                buf.insert(buf.end(), px, px + 4);
        } else {
            buf.insert(buf.end(), extra * 4, 0);
        }
    }
    std::vector<uint8_t> pal(256 * 3), idx((size_t)padded_h * w);
    int rc = timg_libsixel_quant(buf.data(), padded_h, w, (long)w * 4, 256,
                                 pal.data(), idx.data());
    if (rc < 0) return false;
    stage("sixel_quant");
    int ncolors = rc & 0xFFFF;
    long n_bands = (padded_h + 5) / 6;
    size_t cap = (size_t)n_bands * ncolors * (w + 12) + ncolors * 20 + 256;
    // new char[] stays uninitialized: the vector's zero-fill of this
    // multi-MB bound was ~half the assembly stage.
    std::unique_ptr<char[]> six(new char[cap]);
    long sn = timg_sixel_encode(idx.data(), padded_h, w, w, pal.data(),
                                ncolors, six.get());
    if (sn < 0) return false;
    stage("sixel_rle");
    out->assign(six.get(), (size_t)sn);
    return true;
}

// Kitty image ids (fast._kitty_create_id mirror; time-seeded like the
// reference, ref kitty-canvas.cc:48-53).
static uint32_t s_kitty_id_start = 0;
static uint32_t s_kitty_id_counter = 0;

static uint32_t kitty_create_id() {
    if (s_kitty_id_start == 0)
        s_kitty_id_start =
            (uint32_t)(((uint64_t)time(nullptr) << 7) & 0xFFFFFFFFu);
    s_kitty_id_counter += 1;
    return s_kitty_id_start + s_kitty_id_counter;
}

static const size_t kB64Chunk = 4096;                 // protocol max
static const size_t kByteChunk = kB64Chunk / 4 * 3;   // pre-encode bytes

static std::string kitty_payload(const std::string &png,
                                 uint32_t image_id) {
    std::string out;
    char head[96];
    snprintf(head, sizeof(head), "\033_Ga=T,i=%u,q=2,f=100,m=%d;", image_id,
             png.size() > kByteChunk ? 1 : 0);
    out += head;
    size_t pos = 0;
    while (pos < png.size()) {
        size_t nchunk = png.size() - pos;
        if (nchunk > kByteChunk) nchunk = kByteChunk;
        b64_append(&out, (const uint8_t *)png.data() + pos, nchunk);
        pos += nchunk;
        if (pos < png.size()) {
            snprintf(head, sizeof(head), "\033\\\033_Gq=2,m=%d;",
                     png.size() - pos > kByteChunk ? 1 : 0);
            out += head;
        }
    }
    out += "\033\\\n";
    return out;
}

// ---------------------------------------------------------------------
// Title helpers (fast._format_title/_trim_title mirrors).  The python
// mirrors measure in code points; the gate pre-checks everything is
// ASCII so bytes == code points here.
// ---------------------------------------------------------------------
static std::string format_title(const char *fmt, const char *filename,
                                int w, int h) {
    std::string out;
    const char *base = strrchr(filename, '/');
    base = base ? base + 1 : filename;
    char num[16];
    for (const char *p = fmt; *p; ++p) {
        if (*p != '%' || !p[1]) {
            out.push_back(*p);
            continue;
        }
        ++p;
        switch (*p) {
            case 'f': out += filename; break;
            case 'b': out += base; break;
            case 'w':
                snprintf(num, sizeof(num), "%d", w);
                out += num;
                break;
            case 'h':
                snprintf(num, sizeof(num), "%d", h);
                out += num;
                break;
            case 'D': out += "pil"; break;
            default: out.push_back(*p); break;
        }
    }
    return out;
}

static std::string trim_title(const std::string &title, int requested_width,
                              bool center) {
    std::string result = title;
    if ((int)result.size() > requested_width) {
        size_t keep =
            requested_width >= 3 ? (size_t)(requested_width - 3) : 0;
        result = "..." + result.substr(result.size() - keep);
    } else if (center) {
        int start_spaces = (requested_width - (int)result.size()) / 2;
        if (start_spaces > 0)
            result = std::string((size_t)start_spaces, ' ') + result;
    }
    return result + "\n";
}

static bool is_ascii(const char *s) {
    for (; *s; ++s)
        if ((unsigned char)*s >= 0x80) return false;
    return true;
}

// ---------------------------------------------------------------------
// main -- step order mirrors fast.try_fast_main exactly.
// ---------------------------------------------------------------------
int main(int argc, char **argv) {
    g_argc = argc;
    g_argv = argv;
    signal(SIGPIPE, SIG_IGN);  // python-default: write errors, no kill
    {
        const char *tv = getenv("TIMG_TPU_FAST_TIMING");
        if (tv && *tv) {
            s_timing = true;
            s_t_last = now_ms();
        }
    }

    // The host route is the CPU asked for (fast.py's gate): any other
    // device, or the fast path turned off, goes to the server, else to
    // the python launcher.
    const char *forced[] = {"TIMG_TPU_NO_FASTPATH",
                            "TIMG_TPU_NO_NATIVE_LAUNCHER"};
    for (const char *name : forced) {
        const char *v = getenv(name);
        if (v && *v) exec_fallback();
    }
    if (!host_route()) exec_fallback();
    // neither libdeflate.so.0 nor libz.so.1: no PNG decodes or encodes
    // here (the python path has its zlib module)
    if (!*timg_deflate_name()) exec_fallback();
    if (s_timing) fprintf(stderr, "[deflate] %s\n", timg_deflate_name());

    Args args;
    if (!parse_args(argc, argv, &args)) exec_fallback();

    // Warn-y flag values bail BEFORE anything prints.
    static const char *kPixMap[] = {"half", "quarter", "kitty", "iterm2",
                                    "sixel"};
    static const char kPixKeys[] = {'h', 'q', 'k', 'i', 's'};
    auto pix_lookup = [&](char c) -> const char * {
        if (c >= 'A' && c <= 'Z') c += 32;
        for (int k = 0; k < 5; ++k)
            if (kPixKeys[k] == c) return kPixMap[k];
        return nullptr;
    };
    if (args.pixelation && !pix_lookup(args.pixelation[0])) exec_fallback();
    for (const char *v : args.upscale) {
        if (v == BARE) continue;
        char c = v[0];
        if (c >= 'A' && c <= 'Z') c += 32;
        if (c != 'i') exec_fallback();
    }
    if (strcasecmp(args.bg_color, "auto") != 0 &&
        color_would_warn(args.bg_color))
        exec_fallback();
    if (args.bg_pattern_color && color_would_warn(args.bg_pattern_color))
        exec_fallback();

    TermSize tsize = determine_term_size();

    // Resolve pixelation (fast.py mirror of ref timg.cc:742-793).
    const char *pixelation = nullptr;  // NOT_CHOSEN
    const char *env_pix = getenv("TIMG_PIXELATION");
    if (env_pix && *env_pix) {
        const char *m = pix_lookup(env_pix[0]);
        if (m) pixelation = m;
    }
    if (args.pixelation) {
        const char *m = pix_lookup(args.pixelation[0]);
        if (m) pixelation = m;
    }
    bool pixel_named = pixelation &&
                       (strcmp(pixelation, "iterm2") == 0 ||
                        strcmp(pixelation, "kitty") == 0 ||
                        strcmp(pixelation, "sixel") == 0);
    bool cell_unknown_pixel_mode =
        pixel_named &&
        (tsize.font_width_px < 0 || tsize.font_height_px < 0);
    bool have_sixel_opts = false;
    bool sixel_broken_cursor = false, sixel_full_cell_jump = false;
    if (!pixelation) {
        pixelation = "quarter";
        if (tsize.font_width_px > 0 && tsize.font_height_px > 0) {
            GraphicsInfo gi = query_graphics();
            if (gi.preferred == G_ITERM2) {
                pixelation = "iterm2";
            } else if (gi.preferred == G_KITTY) {
                if (gi.in_tmux) exec_fallback();  // passthrough: full path
                pixelation = "kitty";
            } else if (gi.preferred == G_SIXEL) {
                pixelation = "sixel";
                have_sixel_opts = true;
                sixel_broken_cursor = gi.sixel_broken_cursor;
                sixel_full_cell_jump = gi.sixel_full_cell_jump;
            }
        }
    } else if (strcmp(pixelation, "kitty") == 0) {
        if (query_graphics().in_tmux) exec_fallback();
    } else if (strcmp(pixelation, "sixel") == 0) {
        GraphicsInfo gi = query_graphics();
        have_sixel_opts = true;
        sixel_broken_cursor = gi.sixel_broken_cursor;
        sixel_full_cell_jump = gi.sixel_full_cell_jump;
    }
    (void)sixel_full_cell_jump;  // stills never jump cells
    if (strcmp(pixelation, "sixel") == 0 &&
        strcmp(args.dither, "libsixel") != 0)
        exec_fallback();  // cube/adaptive run on the numpy/device path

    // ---- flag handling (fast.py mirror of ref timg.cc:521-718) ----
    int geometry_width = tsize.cols - 2;
    int geometry_height = tsize.rows - 2;
    if (args.geometry) {
        const char *x = strchr(args.geometry, 'x');
        std::string gw(args.geometry,
                       x ? (size_t)(x - args.geometry)
                         : strlen(args.geometry));
        std::string gh(x ? x + 1 : "");
        long v;
        bool bad = false;
        if (!gw.empty()) {
            if (parse_int_strict(gw.c_str(), &v))
                geometry_width = (int)v;
            else
                bad = true;
        }
        if (!bad && !gh.empty()) {
            if (parse_int_strict(gh.c_str(), &v))
                geometry_height = (int)v;
            else
                bad = true;
        }
        if (bad) {
            fprintf(stderr, "Invalid size spec '%s'\n", args.geometry);
            return EXIT_PARAMETER_ERROR;
        }
    }

    double duration_between_images_ms = 0.0;
    double duration_for_row_ms = 0.0;
    if (args.wait) {
        if (args.wait[0] == 'r')
            duration_for_row_ms = py_round(c_atof(args.wait + 1) * 1000.0);
        else
            duration_between_images_ms =
                py_round(c_atof(args.wait) * 1000.0);
    }

    double duration_per_image_ms = INFINITY;
    if (args.has_duration)
        duration_per_image_ms = py_round(args.duration * 1000.0);

    int clear_screen = 0;  // 0 NOT, 1 BEFORE_FIRST, 2 BEFORE_EACH
    for (const char *v : args.clear_vals) {
        if (v == BARE) {
            clear_screen = 1;
        } else {
            std::string lv = lowered(v);
            if (lv.size() <= 5 &&
                strncmp("every", lv.c_str(), lv.size()) == 0) {
                clear_screen = 2;
            } else {
                fprintf(stderr, "Parameter for --clear can be 'every', "
                                "got %s\n", v);
                return EXIT_PARAMETER_ERROR;
            }
        }
    }

    bool antialias = !args.no_antialias;
    std::string bg_color = args.bg_color;
    bool center = args.center;
    bool upscale = ((args.upscale.size() + args.upscale_short) % 2) != 0;
    bool upscale_integer = false;
    for (const char *v : args.upscale) {
        if (v == BARE) continue;
        char c = v[0];
        if (c == 'i' || c == 'I') upscale_integer = true;
    }
    std::string rotate_low = lowered(args.rotate);
    bool exif_rotate = rotate_low != "off";
    if (rotate_low != "exif" && rotate_low != "off") {
        fprintf(stderr, "--rotate=%s: expected 'exif' or 'off'\n",
                args.rotate);
        return EXIT_PARAMETER_ERROR;
    }

    // Scroll (cli.py:257-268; ref timg.cc:583-588).
    bool scroll_animation = !args.scroll_vals.empty();
    double scroll_delay_ms = 50.0;
    long scroll_dx = 1, scroll_dy = 0;
    for (const char *v : args.scroll_vals)
        if (v != BARE) scroll_delay_ms = (double)c_atoi(v);
    if (args.delta_move) {
        std::string dm(args.delta_move);
        const size_t colon = dm.find(':');
        long v0, v1;
        bool ok_d =
            parse_int_strict(dm.substr(0, colon).c_str(), &v0);
        if (ok_d) scroll_dx = v0;
        if (ok_d && colon != std::string::npos) {
            // python split(":")[1]: up to the NEXT colon, if any
            const size_t colon2 = dm.find(':', colon + 1);
            const std::string part1 =
                dm.substr(colon + 1,
                          colon2 == std::string::npos
                              ? std::string::npos
                              : colon2 - colon - 1);
            ok_d = parse_int_strict(part1.c_str(), &v1);
            if (ok_d) scroll_dy = v1;
        }
        if (!ok_d) {
            fprintf(stderr, "--delta-move=%s: invalid\n", args.delta_move);
            return EXIT_PARAMETER_ERROR;
        }
    }

    // Grid spec (cli.py:293-300 mirror of ref timg.cc).  Block-mode
    // grids render natively; pixel-direct grids bail below.
    long grid_cols = 1, grid_rows = 1;
    if (args.grid) {
        const char *x = strchr(args.grid, 'x');
        std::string gw(args.grid,
                       x ? (size_t)(x - args.grid) : strlen(args.grid));
        std::string gh(x ? x + 1 : "");
        bool ok_g = parse_int_strict(gw.c_str(), &grid_cols);
        if (ok_g) {
            if (!gh.empty())
                ok_g = parse_int_strict(gh.c_str(), &grid_rows);
            else
                grid_rows = grid_cols;
        }
        if (!ok_g) {
            fprintf(stderr, "Invalid grid spec '%s'\n", args.grid);
            return EXIT_PARAMETER_ERROR;
        }
        if (grid_cols <= 0 || grid_rows <= 0) exec_fallback();  // py path
    }
    if (grid_cols > 1 && strcmp(pixelation, "half") != 0 &&
        strcmp(pixelation, "quarter") != 0 && cell_unknown_pixel_mode)
        exec_fallback();  // cli collapses the grid + warns: full path

    bool show_title = (args.title.size() % 2) != 0;
    const char *env_title = getenv("TIMG_DEFAULT_TITLE");
    std::string title_format =
        (env_title && *env_title) ? env_title : "%f";
    for (const char *v : args.title)
        if (v != BARE) title_format = v;

    if (clear_screen == 2 && (grid_cols != 1 || grid_rows != 1))
        clear_screen = 1;  // ref: BEFORE_EACH collapses to BEFORE_FIRST

    int output_fd = 1;
    bool opened_fd = false;
    if (args.outfile) {
        output_fd = open(args.outfile, O_WRONLY | O_CREAT | O_TRUNC, 0664);
        if (output_fd < 0) {
            fprintf(stderr, "%s: %s\n", args.outfile, strerror(errno));
            return EXIT_CANT_OPEN_OUTPUT;
        }
        opened_fd = true;
    }
    auto finish = [&](int code) {
        if (opened_fd) close(output_fd);
        return code;
    };
    auto finish_fallback = [&]() {
        if (opened_fd) close(output_fd);
        exec_fallback();
    };

    int compress_level = 1;  // ref display-options.h:52
    for (const char *v : args.compress) {
        int level = (v == BARE) ? 1 : c_atoi(v);
        compress_level = (level >= 0 && level <= 9) ? level : 1;
    }
    bool use_256 = args.color8;
    bool hide_cursor = !args.no_hide_cursor;

    // Filelists (fast.append_to_filelist mirror, ref timg.cc:288-309).
    std::vector<std::string> filelist;
    auto append_filelist = [&](const char *flf, bool relative) -> bool {
        const char *path = strcmp(flf, "-") == 0 ? "/dev/stdin" : flf;
        FILE *f = fopen(path, "r");
        if (!f) {
            fprintf(stderr, "%s: %s\n", flf, strerror(errno));
            return false;
        }
        std::string content;
        char rb[8192];
        size_t n;
        while ((n = fread(rb, 1, sizeof(rb), f)) > 0) content.append(rb, n);
        fclose(f);
        const char *slash = strrchr(flf, '/');
        std::string prefix =
            slash ? std::string(flf, (size_t)(slash - flf) + 1) : "";
        size_t start = 0;
        while (start <= content.size()) {
            size_t nl = content.find('\n', start);
            std::string line = content.substr(
                start, nl == std::string::npos ? std::string::npos
                                               : nl - start);
            if (!line.empty() && line.back() == '\r') line.pop_back();
            if (!line.empty()) {
                if (relative && line[0] != '/' && !prefix.empty())
                    line = prefix + line;
                filelist.push_back(line);
            }
            if (nl == std::string::npos) break;
            start = nl + 1;
        }
        return true;
    };
    for (const char *fl : args.filelist)
        if (!append_filelist(fl, false)) return finish(EXIT_FILELIST_PROBLEM);
    for (const char *fl : args.filelist_rel)
        if (!append_filelist(fl, true)) return finish(EXIT_FILELIST_PROBLEM);

    // ---- sanity sieve (ref timg.cc:726-905) ----
    if (geometry_width < 1 || geometry_height < 1) {
        if (tsize.cols < 0 || tsize.rows < 0)
            fprintf(stderr, "Failed to read size from terminal; Please "
                            "supply -g<width>x<height> directly.\n");
        else
            fprintf(stderr, "%dx%d is a rather unusual size\n",
                    geometry_width, geometry_height);
        return finish(EXIT_NOT_A_TERMINAL);
    }

    if (scroll_dx == 0 && scroll_dy == 0 && scroll_animation) {
        fprintf(stderr, "Scrolling chosen, but dx:dy = 0:0. "
                        "Just showing image, no scroll.\n");
        scroll_animation = false;
    }

    Display disp;
    bool pixel_direct = strcmp(pixelation, "half") != 0 &&
                        strcmp(pixelation, "quarter") != 0;
    if ((strcmp(pixelation, "iterm2") == 0 ||
         strcmp(pixelation, "kitty") == 0) &&
        strcasecmp(bg_color.c_str(), "auto") == 0)
        bg_color = "none";  // ref timg.cc:810-813 (terminal-side alpha)
    bool local_alpha = strcasecmp(bg_color.c_str(), "none") != 0;

    int fw = tsize.font_width_px, fh = tsize.font_height_px;
    double width_stretch;
    if (pixel_direct)
        width_stretch = 1.0;
    else
        width_stretch = (fw != 0) ? 0.5 * fh / fw : INFINITY;
    width_stretch = get_float_env("TIMG_FONT_WIDTH_CORRECT", width_stretch);
    int cell_x, cell_y;
    if (strcmp(pixelation, "half") == 0) {
        cell_x = 1;
        cell_y = 2;
    } else if (strcmp(pixelation, "quarter") == 0) {
        width_stretch *= 2;
        cell_x = 2;
        cell_y = 2;
    } else {
        cell_x = 1;
        cell_y = 2;  // DisplayOptions defaults
        if (cell_unknown_pixel_mode) {
            cell_x = 9;
            cell_y = 18;  // ref timg.cc:742-767
            compress_level = 1;
        } else {
            if (tsize.font_width_px > 0) cell_x = tsize.font_width_px;
            if (tsize.font_height_px > 0) cell_y = tsize.font_height_px;
        }
    }

    int width = geometry_width * cell_x;
    int height = geometry_height * cell_y;

    for (const char *f : args.files) filelist.push_back(f);
    if (filelist.empty()) {
        fprintf(stderr,
                "Expected image filename(s) on command line or via -f\n");
        return finish(EXIT_IMAGE_READ_ERROR);
    }

    // Loops (cli.py:235-238, 448-451; ref timg.cc:555-558, 897-900).
    const long kNotInitialized = -(1L << 31);
    long loops = kNotInitialized;
    if (!args.loops_vals.empty()) {
        const char *v = args.loops_vals.back();
        loops = (v == BARE) ? -1 : c_atoi(v);
    }
    if (filelist.size() > 1 && loops == kNotInitialized &&
        duration_per_image_ms == INFINITY)
        loops = 1;  // ref timg.cc:897-900

    if (show_title) height -= cell_y * (int)grid_rows;  // ref :902-905
    // Less space per picture in a grid (ref timg.cc:937-939).
    width /= (int)grid_cols;
    height /= (int)grid_rows;

    RGBA bg_pattern_color =
        parse_color(args.bg_pattern_color ? args.bg_pattern_color : nullptr);
    bool use_upper = get_bool_env("TIMG_USE_UPPER_BLOCK", false);

    // Non-ASCII titles: the python mirrors trim in code points; bail
    // so bytes==code-points holds for everything we commit to.
    if (show_title) {
        if (!is_ascii(title_format.c_str())) finish_fallback();
        for (const std::string &f : filelist)
            if (!is_ascii(f.c_str())) finish_fallback();
    }

    // ---- input gate: every file an eligible PNG still or cleanly
    // missing (error diagnosis replicated) ----
    std::vector<std::string> missing_msg(filelist.size());
    std::vector<bool> is_missing(filelist.size(), false);
    std::vector<StillKind> kinds(filelist.size(), K_PNG);
    for (size_t i = 0; i < filelist.size(); ++i) {
        const std::string &fname = filelist[i];
        if (fname == "-") finish_fallback();
        struct stat st;
        if (stat(fname.c_str(), &st) != 0) {
            missing_msg[i] = fname + ": No such file or directory";
            is_missing[i] = true;
            continue;
        }
        if (S_ISDIR(st.st_mode)) {
            missing_msg[i] = fname + ": is a directory";
            is_missing[i] = true;
            continue;
        }
        if (access(fname.c_str(), R_OK) != 0) {
            missing_msg[i] = fname + ": Permission denied";
            is_missing[i] = true;
            continue;
        }
        if (!S_ISREG(st.st_mode)) finish_fallback();
        FILE *f = fopen(fname.c_str(), "rb");
        if (!f) finish_fallback();
        unsigned char sig[16];
        size_t n = fread(sig, 1, sizeof(sig), f);
        fclose(f);
        static const unsigned char kPng[8] = {0x89, 'P', 'N', 'G', '\r',
                                              '\n', 0x1a, '\n'};
        // PNG decodes in our own C; JPEG via the dlopen'd
        // Pillow-bundled libjpeg (PIL-identical bytes).  Other stills
        // (GIF/BMP/WebP) decode through PIL in the python fastpath --
        // outside this binary's envelope.
        if (n >= 8 && memcmp(sig, kPng, 8) == 0) {
            kinds[i] = K_PNG;
        } else if (n >= 3 && sig[0] == 0xFF && sig[1] == 0xD8 &&
                   sig[2] == 0xFF && jpeg_api() != nullptr) {
            kinds[i] = K_JPEG;
        } else if (n >= 6 && (memcmp(sig, "GIF87a", 6) == 0 ||
                              memcmp(sig, "GIF89a", 6) == 0)) {
            kinds[i] = K_GIF;
        } else if (n >= 2 && sig[0] == 'B' && sig[1] == 'M') {
            kinds[i] = K_BMP;
        } else {
            finish_fallback();
        }
    }

    disp.width = width;
    disp.height = height;
    disp.cell_x = cell_x;
    disp.cell_y = cell_y;
    disp.width_stretch = width_stretch;
    disp.upscale = upscale;
    disp.upscale_integer = upscale_integer;
    disp.fill_width =
        args.fit_width || (scroll_animation && scroll_dy != 0);
    disp.fill_height = scroll_animation && scroll_dx != 0;
    disp.antialias = antialias;
    disp.exif_rotate = exif_rotate;
    disp.pattern_size = args.pattern_size;
    disp.bg_pattern_color = bg_pattern_color;
    disp.quarter = strcmp(pixelation, "quarter") == 0;
    disp.use_upper = use_upper;
    disp.mode = strcmp(pixelation, "half") == 0     ? Display::HALF
                : strcmp(pixelation, "quarter") == 0 ? Display::QUARTER
                : strcmp(pixelation, "sixel") == 0   ? Display::SIXEL
                : strcmp(pixelation, "kitty") == 0   ? Display::KITTY
                                                     : Display::ITERM2;
    (void)have_sixel_opts;

    // GIF animations render natively for single-column block/kitty
    // sessions; everything else (pixel-direct sixel/iterm2 animations,
    // grids, frame-skip env, unknown cell size) delegates.
    const bool allow_anim =
        grid_cols == 1 &&
        !get_bool_env("TIMG_ALLOW_FRAME_SKIP", false) &&
        !cell_unknown_pixel_mode;

    if (scroll_animation) {
        // scroll shares the animation envelope: single-column, no
        // frame-skip env, known cell size for pixel modes
        if (grid_cols > 1 || get_bool_env("TIMG_ALLOW_FRAME_SKIP", false) ||
            cell_unknown_pixel_mode)
            finish_fallback();
        disp.scroll_on = true;
        disp.scroll_dx = (int)scroll_dx;
        disp.scroll_dy = (int)scroll_dy;
        disp.scroll_delay_ms = scroll_delay_ms;
    }

    // Decode/render pass: any bail aborts before a byte is written.
    BgCache bgc;
    std::vector<Planes> rendered(filelist.size());
    for (size_t i = 0; i < filelist.size(); ++i) {
        if (is_missing[i]) {
            rendered[i].missing = true;
            rendered[i].error = missing_msg[i];
            continue;
        }
        bool still_ok = false;
        try {
            still_ok = render_still(filelist[i].c_str(), kinds[i],
                                    allow_anim, disp, &bgc,
                                    bg_color.c_str(), &rendered[i]);
        } catch (const std::bad_alloc &) {
            // A hostile container can pass the per-decoder budgets yet
            // still exhaust memory at staging time; the python path
            // owns those inputs rather than aborting uncaught.
            still_ok = false;
        }
        if (!still_ok) finish_fallback();
        if (!rendered[i].anim.empty()) continue;  // animation prepped
        if (disp.mode == Display::SIXEL) {
            if (!sixel_payload(rendered[i].frame, rendered[i].target_w,
                               rendered[i].target_h, &bgc, bg_color.c_str(),
                               &rendered[i].sixel_stream))
                finish_fallback();
        }
    }

    // ---- emission (fast.py mirror of cli._present_images for stills) --
    std::vector<std::string> errors;
    bool load_failed = false;
    std::string prefix;
    bool is_first = true;
    double wait_time_ms = duration_between_images_ms > duration_for_row_ms
                              ? duration_between_images_ms
                              : duration_for_row_ms;
    std::vector<char> emit_buf;

    auto prefix_move_dy = [&](int rows) {
        if (rows == 0) return;
        char b[24];
        snprintf(b, sizeof(b), rows < 0 ? "\033[%dA" : "\033[%dB",
                 rows < 0 ? -rows : rows);
        prefix += b;
    };
    auto prefix_move_dx = [&](int cols_) {
        if (cols_ == 0) return;
        char b[24];
        snprintf(b, sizeof(b), cols_ < 0 ? "\033[%dD" : "\033[%dC",
                 cols_ < 0 ? -cols_ : cols_);
        prefix += b;
    };
    // Block-canvas cell_height_for_pixels: trunc((pixels-1)/2)
    // (render/ansi.py:85-87, ref unicode-block-canvas.h:42-45).
    auto cell_height_for_pixels = [](int pixels) {
        const int a = pixels - 1;
        const int q = (a >= 0 ? a : -a) / 2;
        return a >= 0 ? q : -q;
    };

    // Canvas-specific cell_height_for_pixels (renderer headline + dy
    // moves are per-canvas: blocks trunc/2, sixel 6-rounding with the
    // full_cell_jump quirk, kitty/iterm2 ceil by cell height).
    auto canvas_cell_height = [&](int pixels) -> int {
        if (disp.mode == Display::QUARTER || disp.mode == Display::HALF)
            return cell_height_for_pixels(pixels);
        if (disp.mode == Display::SIXEL) {
            const int px = -pixels;
            const int rounded = (px + 5) - (px + 5) % 6;
            return sixel_full_cell_jump
                       ? -((rounded - 6) / cell_y + 1)
                       : -((rounded + cell_y - 1) / cell_y);
        }
        return -((-pixels + cell_y - 1) / cell_y);
    };

    if (grid_cols > 1) {
        // Multi-column contact sheet (render/renderer.py
        // MultiColumnRenderer, ref renderer.cc:81-189): per-image
        // column advance, cursor up to the row start, x-offset by
        // column * column_width, row height equalization.
        const bool grid_blocks = disp.mode == Display::QUARTER ||
                                 disp.mode == Display::HALF;
        long col = -1;
        int highest = 0, last = 0;
        const int column_width = width;  // px per cell column
        for (size_t i = 0; i < filelist.size(); ++i) {
            if (s_interrupted) break;
            Planes &planes = rendered[i];
            if (planes.missing) {
                load_failed = true;
                errors.push_back(planes.error);
                continue;
            }
            signal(SIGINT, sig_handler);
            signal(SIGTERM, sig_handler);
            if (hide_cursor) prefix += "\033[?25l";
            if (clear_screen == 2 || (clear_screen == 1 && is_first))
                prefix += "\033c";
            // render_cb: advance_column (renderer.py:103-112; the
            // pixel-unit cursor_down on wrap is the mirrored quirk).
            col += 1;
            if (col >= grid_cols) {
                const int down = highest - last;
                if (down > 0) prefix_move_dy(down);
                col = 0;
                highest = 0;
            }
            std::string title_s;
            if (show_title)
                title_s = trim_title(
                    format_title(title_format.c_str(),
                                 filelist[i].c_str(), planes.orig_w,
                                 planes.orig_h),
                    column_width / cell_x, center);
            if (0.0 < duration_per_image_ms) {
                int y_offset = col > 0 ? -last : 0;
                const long x_offset = col * (long)column_width;
                if (show_title) {  // headline (renderer.py:136-145)
                    if (y_offset) {
                        const int y_move = canvas_cell_height(y_offset);
                        prefix_move_dy(y_move - 1);
                    }
                    prefix_move_dx((int)(x_offset / cell_x));
                    prefix += title_s;
                    y_offset = 0;
                }
                const int indent =
                    center ? (column_width - planes.target_w) / 2 : 0;
                const long x = indent + x_offset;
                if (y_offset < 0)
                    prefix_move_dy(canvas_cell_height(y_offset));
                std::string body;
                if (grid_blocks) {
                    const int xcell =
                        disp.quarter ? (int)(x / 2) : (int)x;
                    size_t cap = (size_t)planes.hcells *
                                     (planes.wcells * 48 + 24) +
                                 64;
                    if (cap > emit_buf.size()) emit_buf.resize(cap);
                    long bn = timg_ansi_emit(
                        planes.glyph.data(), planes.fg.data(),
                        planes.bg.data(), nullptr, planes.hcells,
                        planes.wcells, xcell, use_256 ? 1 : 0,
                        emit_buf.data());
                    body.assign(emit_buf.data(), (size_t)bn);
                } else {
                    // pixel-direct canvases move the cursor themselves
                    // (kitty/iterm2/sixel send(): move_dx(x/cell_x))
                    prefix_move_dx((int)(x / cell_x));
                    if (disp.mode == Display::SIXEL) {
                        if (sixel_broken_cursor)
                            body = "\033[80l\033[?7730l\033[?8452h" +
                                   planes.sixel_stream + "\n";
                        else
                            body = "\033[80h\033[?7730h\033[?8452l" +
                                   planes.sixel_stream + "\r";
                    } else {
                        const int channels = local_alpha ? 3 : 4;
                        std::vector<uint8_t> raw(
                            (size_t)planes.target_h *
                            (1 + (size_t)planes.target_w * channels));
                        timg_png_sub_filter(planes.frame.data(),
                                            planes.target_h,
                                            planes.target_w, channels,
                                            raw.data());
                        std::string png = encode_png_from_filtered(
                            raw.data(), raw.size(), planes.target_w,
                            planes.target_h, compress_level,
                            !local_alpha);
                        if (disp.mode == Display::ITERM2) {
                            char head[96];
                            snprintf(head, sizeof(head),
                                     "\033]1337;File=size=%zu;"
                                     "width=%dpx;height=%dpx;inline=1:",
                                     png.size(), planes.target_w,
                                     planes.target_h);
                            body = head;
                            b64_append(&body,
                                       (const uint8_t *)png.data(),
                                       png.size());
                            body += "\007\n";
                        } else {
                            body = kitty_payload(png, kitty_create_id());
                        }
                    }
                }
                std::string out = prefix + body;
                reliable_write(output_fd, out.data(), out.size());
                prefix.clear();
                last = planes.target_h;
                if (last > highest) highest = last;
            }
            if (hide_cursor) reliable_write(output_fd, "\033[?25h", 6);
            signal(SIGINT, SIG_DFL);
            signal(SIGTERM, SIG_DFL);
            auto msleep = [](double ms) {
                struct timespec ts;
                ts.tv_sec = (time_t)(ms / 1000.0);
                ts.tv_nsec =
                    (long)((ms / 1000.0 - (double)ts.tv_sec) * 1e9);
                nanosleep(&ts, nullptr);
            };
            if (duration_between_images_ms > 0)
                msleep(duration_between_images_ms);
            if (col == grid_cols - 1 && duration_for_row_ms > 0)
                msleep(duration_for_row_ms);
            is_first = false;
        }
        // renderer.finish() (renderer.py:163-168): cell-unit move.
        if (col != 0 && col != -1) {
            const int down = highest - last;
            if (down > 0) prefix_move_dy(down / cell_y);
        }
    } else
    for (size_t i = 0; i < filelist.size(); ++i) {
        if (s_interrupted) break;
        Planes &planes = rendered[i];
        if (planes.missing) {
            load_failed = true;
            errors.push_back(planes.error);
            continue;
        }
        signal(SIGINT, sig_handler);
        signal(SIGTERM, sig_handler);
        if (hide_cursor) prefix += "\033[?25l";
        if (clear_screen == 2 || (clear_screen == 1 && is_first))
            prefix += "\033c";
        if (show_title) {
            std::string title = format_title(
                title_format.c_str(), filelist[i].c_str(), planes.orig_w,
                planes.orig_h);
            prefix += trim_title(title, width / cell_x, center);
        }
        if (!planes.anim.empty()) {
            // ---- GIF animation (base.send_frames + sequencer pacing
            // mirror; blocks: ansi.send_planes diff; kitty: flip-flop
            // ids, ref kitty-canvas.cc:143-172) ----
            const bool loop_forever = loops < 0 || loops == kNotInitialized;
            double tfff = 0.0;
            int last_height = 0;
            bool first_frame = true;
            long k = 0;
            double anim_start = 0.0, last_end_ms = 0.0;
            uint32_t kitty_anim_id = 0;
            long flip = 0;
            const AnimFrame *prev_af = nullptr;
            long last_x_cells = -1;
            int last_h_px = 0;
            const int indent =
                planes.scroll ? 0
                              : (center ? (width - planes.target_w) / 2
                                        : 0);
            std::vector<uint8_t> eq;
            while ((loop_forever || k < loops) && !s_interrupted &&
                   tfff < duration_per_image_ms) {
                for (size_t f = 0; f < planes.anim.size(); ++f) {
                    if (s_interrupted) break;
                    const AnimFrame &af = planes.anim[f];
                    // scroll checks the budget BEFORE the frame and
                    // passes raw times (sources/scroll.py:88-101);
                    // animations clamp and check after (base.py:82-100)
                    if (planes.scroll && tfff > duration_per_image_ms)
                        break;
                    tfff += af.delay_ms;
                    const double end_of_frame =
                        planes.scroll ? tfff
                        : (tfff < duration_per_image_ms
                               ? tfff
                               : duration_per_image_ms);
                    const int dy = last_height > 0 ? -last_height : 0;
                    std::string body;
                    bool drop_prefix_on_empty = false;
                    if (disp.mode == Display::SIXEL) {
                        if (dy < 0) {
                            // sixel cell rounding (ref :157-172)
                            const int px = -dy;
                            const int rounded = (px + 5) - (px + 5) % 6;
                            const int cells =
                                sixel_full_cell_jump
                                    ? -((rounded - 6) / cell_y + 1)
                                    : -((rounded + cell_y - 1) / cell_y);
                            prefix_move_dy(cells);
                        }
                        prefix_move_dx(indent / cell_x);
                        if (sixel_broken_cursor)
                            body = "\033[80l\033[?7730l\033[?8452h" +
                                   af.sixel_stream + "\n";
                        else
                            body = "\033[80h\033[?7730h\033[?8452l" +
                                   af.sixel_stream + "\r";
                    } else if (disp.mode == Display::ITERM2) {
                        if (dy < 0) {
                            const int cells =
                                -((-dy + cell_y - 1) / cell_y);
                            prefix_move_dy(cells);
                        }
                        prefix_move_dx(indent / cell_x);
                        const int channels = local_alpha ? 3 : 4;
                        std::vector<uint8_t> raw(
                            (size_t)planes.target_h *
                            (1 + (size_t)planes.target_w * channels));
                        timg_png_sub_filter(af.frame.data(),
                                            planes.target_h,
                                            planes.target_w, channels,
                                            raw.data());
                        std::string png = encode_png_from_filtered(
                            raw.data(), raw.size(), planes.target_w,
                            planes.target_h, compress_level,
                            !local_alpha);
                        char head[96];
                        snprintf(head, sizeof(head),
                                 "\033]1337;File=size=%zu;width=%dpx;"
                                 "height=%dpx;inline=1:",
                                 png.size(), planes.target_w,
                                 planes.target_h);
                        body = head;
                        b64_append(&body, (const uint8_t *)png.data(),
                                   png.size());
                        body += "\007\n";
                    } else if (disp.mode == Display::KITTY) {
                        if (dy < 0) {
                            // kitty cell_height_for_pixels: ceil cells
                            const int cells =
                                -((-dy + cell_y - 1) / cell_y);
                            prefix_move_dy(cells);
                        }
                        prefix_move_dx(indent / cell_x);
                        uint32_t id;
                        if (first_frame) {
                            id = kitty_create_id();
                            kitty_create_id();  // reserve flip buffer
                            kitty_anim_id = id;
                            flip = 0;
                        } else {
                            flip += 1;
                            id = kitty_anim_id + (uint32_t)(flip % 2);
                        }
                        const int channels = local_alpha ? 3 : 4;
                        std::vector<uint8_t> raw(
                            (size_t)planes.target_h *
                            (1 + (size_t)planes.target_w * channels));
                        timg_png_sub_filter(af.frame.data(),
                                            planes.target_h,
                                            planes.target_w, channels,
                                            raw.data());
                        std::string png = encode_png_from_filtered(
                            raw.data(), raw.size(), planes.target_w,
                            planes.target_h, compress_level,
                            !local_alpha);
                        body = kitty_payload(png, id);
                    } else {
                        if (dy < 0)
                            prefix_move_dy(cell_height_for_pixels(dy));
                        const long x_cells =
                            disp.quarter ? indent / 2 : indent;
                        const bool emit_diff =
                            x_cells == last_x_cells && last_h_px > 0 &&
                            -dy == last_h_px && prev_af != nullptr &&
                            prev_af->padded.size() == af.padded.size() &&
                            prev_af->hcells == af.hcells &&
                            prev_af->wcells == af.wcells;
                        if (emit_diff) {
                            eq.assign((size_t)af.hcells * af.wcells, 0);
                            const int n = disp.quarter ? 2 : 1;
                            const size_t rowpx = (size_t)af.wcells * n * 4;
                            for (int r = 0; r < af.hcells; ++r)
                                for (int c = 0; c < af.wcells; ++c) {
                                    const size_t o0 =
                                        (size_t)(r * 2) * rowpx +
                                        (size_t)c * n * 4;
                                    const size_t o1 = o0 + rowpx;
                                    eq[(size_t)r * af.wcells + c] =
                                        memcmp(&af.padded[o0],
                                               &prev_af->padded[o0],
                                               (size_t)n * 4) == 0 &&
                                        memcmp(&af.padded[o1],
                                               &prev_af->padded[o1],
                                               (size_t)n * 4) == 0;
                                }
                        }
                        size_t cap = (size_t)af.hcells *
                                         (af.wcells * 48 + 24) +
                                     64;
                        if (cap > emit_buf.size()) emit_buf.resize(cap);
                        long bn = timg_ansi_emit(
                            af.glyph.data(), af.fg.data(), af.bg.data(),
                            emit_diff ? eq.data() : nullptr, af.hcells,
                            af.wcells, (int)x_cells, use_256 ? 1 : 0,
                            emit_buf.data());
                        body.assign(emit_buf.data(), (size_t)bn);
                        drop_prefix_on_empty = true;
                        last_x_cells = x_cells;
                        last_h_px = planes.target_h;
                        prev_af = &af;
                    }
                    // Sequencer pacing (render/sequencer.py:95-108):
                    // START_OF_ANIMATION stamps t0; ANIMATION_FRAME
                    // sleeps to t0 + previous frame's end time.
                    if (first_frame) {
                        anim_start = now_s();
                    } else if (last_end_ms > 0 &&
                               !args.debug_no_frame_delay) {
                        const double finish =
                            anim_start + last_end_ms / 1000.0;
                        const double nw = now_s();
                        if (finish > nw) {
                            struct timespec ts;
                            const double delta = finish - nw;
                            ts.tv_sec = (time_t)delta;
                            ts.tv_nsec = (long)((delta -
                                                 (double)ts.tv_sec) * 1e9);
                            nanosleep(&ts, nullptr);
                        }
                    }
                    last_end_ms = end_of_frame;
                    if (body.empty() && drop_prefix_on_empty) {
                        // unchanged frame: zero-size write, prefix
                        // dropped (ansi.send_planes, ref :390-395)
                        prefix.clear();
                    } else {
                        std::string outb = prefix + body;
                        reliable_write(output_fd, outb.data(),
                                       outb.size());
                        prefix.clear();
                    }
                    last_height = planes.target_h;
                    if (!planes.scroll && tfff > duration_per_image_ms)
                        break;
                    first_frame = false;
                }
                ++k;
            }
        } else if (0.0 < duration_per_image_ms) {
            std::string body;
            if (!planes.is_blocks) {
                int target_w = planes.target_w, target_h = planes.target_h;
                int indent = center ? (width - target_w) / 2 : 0;
                int dx_cells = indent / cell_x;
                if (dx_cells > 0) {
                    char mv[24];
                    snprintf(mv, sizeof(mv), "\033[%dC", dx_cells);
                    prefix += mv;
                }
                if (disp.mode == Display::SIXEL) {
                    if (sixel_broken_cursor)
                        body = "\033[80l\033[?7730l\033[?8452h" +
                               planes.sixel_stream + "\n";
                    else
                        body = "\033[80h\033[?7730h\033[?8452l" +
                               planes.sixel_stream + "\r";
                } else {
                    int channels = local_alpha ? 3 : 4;
                    std::vector<uint8_t> raw(
                        (size_t)target_h * (1 + (size_t)target_w * channels));
                    timg_png_sub_filter(planes.frame.data(), target_h,
                                        target_w, channels, raw.data());
                    stage("sub_filter");
                    std::string png = encode_png_from_filtered(
                        raw.data(), raw.size(), target_w, target_h,
                        compress_level, !local_alpha);
                    stage("deflate");
                    if (disp.mode == Display::ITERM2) {
                        char head[96];
                        snprintf(head, sizeof(head),
                                 "\033]1337;File=size=%zu;width=%dpx;"
                                 "height=%dpx;inline=1:",
                                 png.size(), target_w, target_h);
                        body = head;
                        b64_append(&body, (const uint8_t *)png.data(),
                                   png.size());
                        body += "\007\n";
                    } else {
                        body = kitty_payload(png, kitty_create_id());
                    }
                }
            } else {
                int indent = center ? (width - planes.target_w) / 2 : 0;
                int x = disp.quarter ? indent / 2 : indent;
                size_t cap =
                    (size_t)planes.hcells * (planes.wcells * 48 + 24) + 64;
                if (cap > emit_buf.size()) emit_buf.resize(cap);
                long bn = timg_ansi_emit(planes.glyph.data(),
                                         planes.fg.data(), planes.bg.data(),
                                         nullptr, planes.hcells,
                                         planes.wcells, x, use_256 ? 1 : 0,
                                         emit_buf.data());
                body.assign(emit_buf.data(), (size_t)bn);
            }
            std::string out = prefix + body;
            reliable_write(output_fd, out.data(), out.size());
            prefix.clear();
        }
        if (hide_cursor) reliable_write(output_fd, "\033[?25h", 6);
        signal(SIGINT, SIG_DFL);
        signal(SIGTERM, SIG_DFL);
        if (wait_time_ms > 0) {
            struct timespec ts;
            ts.tv_sec = (time_t)(wait_time_ms / 1000.0);
            ts.tv_nsec = (long)((wait_time_ms / 1000.0 - (double)ts.tv_sec) *
                                1e9);
            nanosleep(&ts, nullptr);
        }
        is_first = false;
    }

    if (!prefix.empty())  // canvas.close(): leftover prefix flushed
        reliable_write(output_fd, prefix.data(), prefix.size());

    int exit_code = EXIT_OK;
    if (!errors.empty() || load_failed) exit_code = EXIT_IMAGE_READ_ERROR;
    for (size_t i = 0; i < errors.size() && i < 4; ++i)
        fprintf(stderr, "%s\n", errors[i].c_str());
    if (errors.size() >= 4)
        fprintf(stderr, "... total of %zu errors\n", errors.size());

    if (s_interrupted)
        fprintf(stderr, "\033[0m\033[%dB\n",
                tsize.rows > 1 ? tsize.rows : 1);

    stage("emit+rest");
    return finish(exit_code);
}
